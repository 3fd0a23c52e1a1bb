"""Train-state checkpoints (reference ``parallel/checkpoint.py``, on orbax
there, on ``torch.save`` here): one file ``step_%08d`` a step in a
directory, holding the model's and the optimizer's state and the step.

A save writes a temporary ``step_%08d.tmp-<pid>`` and renames it into
place with ``os.replace``; :func:`latest_checkpoint` takes exact names
only, as the reference's regex does, so an interrupted save is never
picked.
"""
from __future__ import annotations

import os
import re

import torch

_NAME = re.compile(r"step_\d{8}")


def save_checkpoint(ckpt_dir: str, state, step: int | None = None) -> str:
    """Write ``state`` (a :class:`~.train.TrainState`) at ``step`` (its
    own by default) under ``ckpt_dir``; returns the path."""
    step = int(state.step if step is None else step)
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(os.path.abspath(ckpt_dir), f"step_{step:08d}")
    tmp = f"{path}.tmp-{os.getpid()}"
    torch.save({"model": state.model.state_dict(),
                "optimizer": state.optimizer.state_dict(), "step": step}, tmp)
    os.replace(tmp, path)
    return path


def latest_checkpoint(ckpt_dir: str) -> str | None:
    """The path of the newest complete checkpoint in ``ckpt_dir``, or
    None."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = sorted(d for d in os.listdir(ckpt_dir) if _NAME.fullmatch(d))
    return os.path.join(os.path.abspath(ckpt_dir), steps[-1]) if steps else None


def restore_checkpoint(ckpt_dir: str, state):
    """Load the latest checkpoint of ``ckpt_dir`` into ``state``'s model,
    optimizer and step, on their device; returns ``state``, or None when
    no checkpoint exists."""
    path = latest_checkpoint(ckpt_dir)
    if path is None:
        return None
    saved = torch.load(path, map_location="cpu", weights_only=True)
    state.model.load_state_dict(saved["model"])
    state.optimizer.load_state_dict(saved["optimizer"])
    state.step = int(saved["step"])
    return state
