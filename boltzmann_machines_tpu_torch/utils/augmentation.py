"""Image augmentation: one-pixel shifts and horizontal mirroring, numpy
(the JAX package's ``utils/augmentation.py``; reference
utils/augmentation.py:5-15).  examples/torch_dbm_cifar.py's x10
augmentation uses them where the native library is not built."""

import numpy as np


def shift(X, offset=(0, 0)):
    """Shift a (H, W) or (H, W, C) image by integer `offset` = (dy, dx),
    zero-filling vacated pixels."""
    X = np.asarray(X)
    dy, dx = offset
    out = np.zeros_like(X)
    src_y = slice(max(0, -dy), X.shape[0] - max(0, dy))
    dst_y = slice(max(0, dy), X.shape[0] - max(0, -dy))
    src_x = slice(max(0, -dx), X.shape[1] - max(0, dx))
    dst_x = slice(max(0, dx), X.shape[1] - max(0, -dx))
    out[dst_y, dst_x, ...] = X[src_y, src_x, ...]
    return out


def horizontal_mirror(X):
    """Mirror a (H, W) or (H, W, C) image horizontally."""
    return np.asarray(X)[:, ::-1, ...].copy()
