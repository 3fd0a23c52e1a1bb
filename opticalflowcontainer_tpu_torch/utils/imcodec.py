"""Image bytes to BGR by their signature, in place of ``cv2.imdecode(buf,
cv2.IMREAD_COLOR)`` and ``cv2.imread`` for the two formats the port reads:
JPEG (``FF D8``, :mod:`.jpeg`) and PNG (``89 'PNG'``, :mod:`.png`).
Anything else, and truncated or damaged data, gives None, as cv2 does; a
valid file of a kind the decoders do not read raises ``ValueError`` naming
it.  The decoders run their compiled forms unless ``force_python`` asks for
the plain ones.
"""
from __future__ import annotations

import numpy as np

from . import jpeg, png


def imdecode(buf, force_python: bool = False,
             name: str = "image data") -> np.ndarray | None:
    """The JPEG or PNG file in ``buf`` (bytes, or a uint8 array) as BGR
    uint8 [H, W, 3], or None."""
    data = buf if isinstance(buf, bytes) else bytes(buf)
    if data.startswith(b"\xff\xd8"):
        return jpeg.imdecode(data, force_python, name)
    if data.startswith(png._SIGNATURE):
        return png.imdecode(data, force_python, name)
    return None


def imread(path: str, force_python: bool = False) -> np.ndarray | None:
    """The JPEG or PNG file at ``path`` as ``cv2.imread`` returns it (BGR
    uint8), or None."""
    with open(path, "rb") as f:
        return imdecode(f.read(), force_python, name=path)
