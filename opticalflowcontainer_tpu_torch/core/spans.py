"""Named spans at the program's stage boundaries, on the timeline of any
``torch.profiler`` trace (the host's operators and the card's kernels and
copies on one clock), and free when no profiler runs.

:func:`annotate` is the one span primitive of the package
(``runtime.tracing.annotate`` is this function).  With no profiler running
it returns one shared no-op context, which costs under a microsecond of
host time; a bare ``torch.profiler.record_function`` costs about ten.

The span names, each under the prefix ``ofc.``:

- :data:`FARNEBACK_UPLOAD` -- Farneback's frames (or initial flow) to the
  device and to fp32;
- :data:`FARNEBACK_PREP` -- one pyramid level's prep of a batch of frames:
  the blur at full resolution, the resize to the level and the polynomial
  expansion into five planes (clip, batched pair and stream step alike);
- :data:`FARNEBACK_SOLVE` -- one pyramid level's solve: the flow resized
  to the level, then its K1 (update) and K2 (blur and solve) iterations;
- :data:`MODEL_RESIZE_IN`, :data:`MODEL_FORWARD`, :data:`MODEL_RESIZE_OUT`
  -- a learned model's estimate contract: the frames to NCHW in the
  serving dtype and resized to the net's multiple, the net's forward, and
  the flow resized back and rescaled;
- :data:`PWCNET_EXTRACTOR`, :data:`PWCNET_DECODER` (one name a level, 6 to
  2), :data:`PWCNET_REFINER` -- PWC-Net's stages inside its forward;
- :data:`RAFT_ENCODE` -- RAFT's feature encoder on both frames and its
  context encoder, up to the hidden state and the context;
- :data:`RAFT_VOLUME` -- RAFT's all-pairs product, its pyramid and the
  packing of the levels side by side;
- :data:`RAFT_LOOKUP` -- one windowed lookup of the packed pyramid
  (``ops/allpairs.py`` ``lookup_packed``), one an update;
- :data:`RAFT_UPDATE` -- one recurrent update after its lookup: the motion
  encoder, the GRU and the flow head;
- :data:`RAFT_UPSAMPLE` -- the flow upsampled 8x (RAFT's convex
  combination, RAFT-small's bilinear resize);
- :data:`STREAM_STEP` -- a fused stream's ``step``, the whole method: the
  frame's enqueue, up to the unsynced du;
- :data:`STREAM_UPLOAD` -- the frame (and mask) to the device;
- :data:`STREAM_AGGREGATE` -- the mean or median of u over the mask;
- :data:`STREAM_WAIT` -- a fused backend's host blocked on the card for du;
- :data:`BUILD` -- a constant table built again on a cache miss
  (``core.device.cached_tensors``): a new shape, or an evicted entry.
"""
from __future__ import annotations

import contextlib

import torch

FARNEBACK_UPLOAD = "ofc.farneback.upload"
FARNEBACK_PREP = "ofc.farneback.prep"
FARNEBACK_SOLVE = "ofc.farneback.solve"
MODEL_RESIZE_IN = "ofc.model.resize_in"
MODEL_FORWARD = "ofc.model.forward"
MODEL_RESIZE_OUT = "ofc.model.resize_out"
PWCNET_EXTRACTOR = "ofc.pwcnet.extractor"
PWCNET_DECODER = {level: f"ofc.pwcnet.decoder{level}" for level in (6, 5, 4, 3, 2)}
PWCNET_REFINER = "ofc.pwcnet.refiner"
RAFT_ENCODE = "ofc.raft.encode"
RAFT_VOLUME = "ofc.raft.volume"
RAFT_LOOKUP = "ofc.raft.lookup"
RAFT_UPDATE = "ofc.raft.update"
RAFT_UPSAMPLE = "ofc.raft.upsample"
STREAM_STEP = "ofc.stream.step"
STREAM_UPLOAD = "ofc.stream.upload"
STREAM_AGGREGATE = "ofc.stream.aggregate"
STREAM_WAIT = "ofc.stream.wait"
BUILD = "ofc.build"

_NO_SPAN = contextlib.nullcontext()


def annotate(name: str):
    """A span named ``name`` (``with annotate(name): ...``) while a profiler
    runs, else the one shared no-op context.

    The span is PyTorch's fast record function, a host event like an
    operator's: under a profiler it costs a few microseconds where
    ``torch.profiler.record_function`` costs over ten, and unlike that
    user annotation it is not mirrored onto the card's timeline as a range,
    which a reader of the trace could take for device work."""
    if torch.autograd._profiler_enabled():
        return torch._C._profiler._RecordFunctionFast(name)
    return _NO_SPAN
