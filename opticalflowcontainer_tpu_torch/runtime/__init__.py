"""Streaming runtime: pixel flow -> metric velocity on the port's Farneback."""
