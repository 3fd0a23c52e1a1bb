"""Learned flow models (reference ``models/``): PWC-Net so far."""
