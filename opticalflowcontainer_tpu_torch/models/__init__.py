"""Learned flow models (reference ``models/``): PWC-Net, LiteFlowNet and
LiteFlowNet3."""
from .liteflownet import LiteFlowNet
from .liteflownet3 import LiteFlowNet3
from .pwcnet import PWCNet

__all__ = ["LiteFlowNet", "LiteFlowNet3", "PWCNet"]
