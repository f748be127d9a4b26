"""ctypes bridge to the native (C++) data-path helpers.

Compiles native/bm_native.cpp on first use (g++, cached next to the source);
every entry point has a pure-numpy fallback, so the library works without a
toolchain -- the native path is a host-side accelerator, not a dependency.
"""

import ctypes
import os
import subprocess

import numpy as np

_LIB = None
_TRIED = False


def _source_path():
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return os.path.join(here, 'native', 'bm_native.cpp')


def _lib_path():
    return os.path.join(os.path.dirname(_source_path()), 'libbm_native.so')


def load_native():
    """Return the loaded native library, building it if needed; None when
    unavailable (no g++ / no source)."""
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    src = _source_path()
    lib = _lib_path()
    try:
        if not os.path.isfile(src):
            return None
        if (not os.path.isfile(lib) or
                os.path.getmtime(lib) < os.path.getmtime(src)):
            subprocess.check_call(
                ['g++', '-O3', '-shared', '-fPIC', src, '-o', lib],
                stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        L = ctypes.CDLL(lib)
        L.bm_load_idx3.restype = ctypes.c_longlong
        L.bm_load_idx1.restype = ctypes.c_longlong
        L.bm_load_cifar_bin.restype = ctypes.c_longlong
        L.bm_augment_x10.restype = None
        if hasattr(L, 'bm_augment_x10_u8'):
            L.bm_augment_x10_u8.restype = None
        _LIB = L
    except (OSError, subprocess.CalledProcessError):
        _LIB = None
    return _LIB


def _fptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def load_idx3(path, n_max=10 ** 9, scale=1.0):
    """Native IDX3 image reader -> (n, rows*cols) float32, or None."""
    L = load_native()
    if L is None:
        return None
    import struct
    with open(path, 'rb') as f:
        magic, n, rows, cols = struct.unpack('>IIII', f.read(16))
    n = min(n, n_max)
    out = np.empty((n, rows * cols), dtype=np.float32)
    r = ctypes.c_longlong(0)
    c = ctypes.c_longlong(0)
    got = L.bm_load_idx3(path.encode(), _fptr(out),
                         ctypes.c_longlong(n), ctypes.byref(r),
                         ctypes.byref(c), ctypes.c_float(scale))
    if got != n:
        return None
    return out


def load_idx1(path, n_max=10 ** 9):
    """Native IDX1 label reader -> (n,) int32, or None."""
    L = load_native()
    if L is None:
        return None
    import struct
    with open(path, 'rb') as f:
        magic, n = struct.unpack('>II', f.read(8))
    n = min(n, n_max)
    out = np.empty((n,), dtype=np.int32)
    got = L.bm_load_idx1(path.encode(),
                         out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                         ctypes.c_longlong(n))
    if got != n:
        return None
    return out


def augment_x10_u8_flat(X_im):
    """Fused x10 augmentation -> uint8 cache layout: (N, H, W, C) float32
    in [0, 1] -> (10N, C*H*W) uint8 (im_flatten's channel-major order,
    pixels truncated from v*255 exactly like numpy's astype).  Writes the
    1-byte cache directly instead of a 4-byte float intermediate -- the
    multi-GB first-touch page faults of the float path dominate wall-clock
    in some virtual machines.  Returns None when the
    native library is unavailable (callers fall back to
    `augment_x10` + host conversion)."""
    X_im = np.ascontiguousarray(X_im, dtype=np.float32)
    N, H, W, C = X_im.shape
    L = load_native()
    if L is None or not hasattr(L, 'bm_augment_x10_u8'):
        return None
    out = np.empty((10 * N, C * H * W), dtype=np.uint8)
    L.bm_augment_x10_u8(_fptr(X_im),
                        out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
                        ctypes.c_longlong(N), ctypes.c_longlong(H),
                        ctypes.c_longlong(W), ctypes.c_longlong(C))
    return out


def augment_x10(X_im):
    """x10 CIFAR augmentation; X_im: (N, H, W, C) float32 ->
    (10N, H, W, C) float32.  Numpy fallback when native is unavailable."""
    X_im = np.ascontiguousarray(X_im, dtype=np.float32)
    N, H, W, C = X_im.shape
    L = load_native()
    if L is not None:
        out = np.empty((10 * N, H, W, C), dtype=np.float32)
        L.bm_augment_x10(_fptr(X_im), _fptr(out),
                         ctypes.c_longlong(N), ctypes.c_longlong(H),
                         ctypes.c_longlong(W), ctypes.c_longlong(C))
        return out
    # numpy fallback (same layout as reference dbm_cifar.py:69-88)
    from .augmentation import shift, horizontal_mirror
    out = np.zeros((10 * N, H, W, C), dtype=np.float32)
    out[:N] = X_im
    for k, offset in enumerate(((1, 0), (-1, 0), (0, 1), (0, -1))):
        for i in range(N):
            out[(k + 1) * N + i] = shift(X_im[i], offset)
    for i in range(5 * N):
        out[5 * N + i] = horizontal_mirror(out[i])
    return out
