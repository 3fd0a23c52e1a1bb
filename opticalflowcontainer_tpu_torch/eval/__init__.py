"""Offline accuracy harness (the port's copy of the reference's ``eval``
package): EPE metrics, the Sintel / KITTI loaders, the synthetic and
fishnet affine pair generators, and the ``run_eval`` CLI."""
from .epe import epe, epe_stats, outlier_rate
from .datasets import KittiFlowDataset, SintelDataset, synthetic_eval_pairs

__all__ = [
    "epe",
    "epe_stats",
    "outlier_rate",
    "SintelDataset",
    "KittiFlowDataset",
    "synthetic_eval_pairs",
]
