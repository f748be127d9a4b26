"""Minimal dependency-free PNG encoder (grayscale / RGB uint8) used by the
TensorBoard image summaries."""

import struct
import zlib

import numpy as np


def encode_png(img):
    """Encode a (H, W) or (H, W, 3) uint8 array as PNG bytes."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError('encode_png expects uint8')
    if img.ndim == 2:
        img = img[:, :, None]
    h, w, c = img.shape
    if c == 1:
        color_type = 0
    elif c == 3:
        color_type = 2
    else:
        raise ValueError('1 or 3 channels required')

    def chunk(tag, data):
        out = struct.pack('>I', len(data)) + tag + data
        out += struct.pack('>I', zlib.crc32(tag + data) & 0xFFFFFFFF)
        return out

    ihdr = struct.pack('>IIBBBBB', w, h, 8, color_type, 0, 0, 0)
    raw = b''.join(b'\x00' + img[y].tobytes() for y in range(h))
    return (b'\x89PNG\r\n\x1a\n'
            + chunk(b'IHDR', ihdr)
            + chunk(b'IDAT', zlib.compress(raw, 6))
            + chunk(b'IEND', b''))
