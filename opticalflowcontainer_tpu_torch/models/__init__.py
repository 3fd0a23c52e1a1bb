"""Learned flow models (reference ``models/``): PWC-Net, LiteFlowNet,
LiteFlowNet3, RAFT-small and RAFT (large)."""
from .liteflownet import LiteFlowNet
from .liteflownet3 import LiteFlowNet3
from .pwcnet import PWCNet
from .raft import RAFT, RAFTSmall

__all__ = ["LiteFlowNet", "LiteFlowNet3", "PWCNet", "RAFT", "RAFTSmall"]
