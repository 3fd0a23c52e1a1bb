"""Learned flow models (reference ``models/``): PWC-Net, LiteFlowNet,
LiteFlowNet3, RAFT-small, RAFT (large), NeuFlowLite and NeuFlow-v2."""
from .liteflownet import LiteFlowNet
from .liteflownet3 import LiteFlowNet3
from .neuflow import NeuFlowLite
from .neuflow_v2 import NeuFlowV2
from .pwcnet import PWCNet
from .raft import RAFT, RAFTSmall

__all__ = ["LiteFlowNet", "LiteFlowNet3", "NeuFlowLite", "NeuFlowV2", "PWCNet",
           "RAFT", "RAFTSmall"]
