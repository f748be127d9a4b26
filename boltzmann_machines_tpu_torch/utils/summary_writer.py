"""Dependency-free TensorBoard event-file writer.

The reference streams scalar metrics to TensorBoard via TF FileWriters
(tf_model.py:110-115); this module reproduces that observability channel
without TensorFlow: it hand-encodes the tiny protobuf subset TensorBoard
needs (Event{wall_time, step, Summary{value{tag, simple_value}}}) and frames
records in the TFRecord format (length + masked crc32c).

Files land in the model's logs/train and logs/val directories and open in
stock TensorBoard.  Also mirrors every scalar to a plain JSONL stream next
to the event file for tooling that prefers text.
"""

import json
import os
import struct
import threading
import time

# ---------------------------------------------------------------------- #
# crc32c (software implementation, Castagnoli polynomial)                 #
# ---------------------------------------------------------------------- #
_CRC_TABLE = []


def _make_table():
    poly = 0x82F63B78
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ (poly if crc & 1 else 0)
        _CRC_TABLE.append(crc)


_make_table()


def _crc32c(data):
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data):
    crc = _crc32c(data)
    return ((((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF)


# ---------------------------------------------------------------------- #
# minimal protobuf encoding                                               #
# ---------------------------------------------------------------------- #
def _varint(n):
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field, wire):
    return _varint((field << 3) | wire)


def _pb_double(field, value):
    return _key(field, 1) + struct.pack('<d', value)


def _pb_float(field, value):
    return _key(field, 5) + struct.pack('<f', value)


def _pb_int64(field, value):
    return _key(field, 0) + _varint(value & 0xFFFFFFFFFFFFFFFF)


def _pb_bytes(field, data):
    return _key(field, 2) + _varint(len(data)) + data


def _event(value_bytes, step, wall_time):
    # Summary { value = 1 (repeated message) };
    # Event { wall_time = 1 (double); step = 2 (int64); summary = 5 }
    return (_pb_double(1, wall_time) + _pb_int64(2, int(step)) +
            _pb_bytes(5, _pb_bytes(1, value_bytes)))


def _encode_event(tag, value, step, wall_time):
    # Summary.Value { tag = 1 (string); simple_value = 2 (float) }
    sval = _pb_bytes(1, tag.encode()) + _pb_float(2, float(value))
    return _event(sval, step, wall_time)


def _encode_image_event(tag, png_bytes, height, width, channels, step,
                        wall_time):
    # Summary.Image { height=1; width=2; colorspace=3; encoded=4 }
    img = (_pb_int64(1, height) + _pb_int64(2, width) +
           _pb_int64(3, 1 if channels == 1 else 3) +
           _pb_bytes(4, png_bytes))
    # Summary.Value { tag = 1; image = 4 }
    sval = _pb_bytes(1, tag.encode()) + _pb_bytes(4, img)
    return _event(sval, step, wall_time)


def _encode_histogram_from_buckets(tag, edges, counts, vmin, vmax, num,
                                   vsum, vsum_sq, step, wall_time):
    """HistogramProto from precomputed bucket counts over `edges`
    (len(edges) == len(counts) + 1)."""
    import numpy as np
    counts = np.asarray(counts)
    nz = counts.nonzero()[0]
    if len(nz) == 0:
        keep = [0]
    else:
        keep = range(max(nz[0] - 1, 0), min(nz[-1] + 1, len(counts) - 1) + 1)
    # HistogramProto { min=1; max=2; num=3; sum=4; sum_squares=5;
    #                  bucket_limit=7 (repeated); bucket=8 (repeated) }
    histo = (_pb_double(1, float(vmin)) +
             _pb_double(2, float(vmax)) +
             _pb_double(3, float(num)) +
             _pb_double(4, float(vsum)) +
             _pb_double(5, float(vsum_sq)))
    for i in keep:
        histo += _pb_double(7, float(edges[i + 1]))
        histo += _pb_double(8, float(counts[i]))
    # Summary.Value { tag = 1; histo = 5 }
    sval = _pb_bytes(1, tag.encode()) + _pb_bytes(5, histo)
    return _event(sval, step, wall_time)


def _encode_histogram_event(tag, values, step, wall_time):
    import numpy as np
    values = np.asarray(values, dtype=np.float64).ravel()
    # TensorBoard's standard exponential bucket boundaries
    neg = [-(1.1 ** i) * 1e-12 for i in range(0, 776)][::-1]
    pos = [(1.1 ** i) * 1e-12 for i in range(0, 776)]
    edges = np.asarray(neg + [0.0] + pos + [1e308])
    counts, _ = np.histogram(values, bins=edges)
    return _encode_histogram_from_buckets(
        tag, edges, counts, values.min(), values.max(), values.size,
        values.sum(), (values ** 2).sum(), step, wall_time)


class SummaryWriter(object):
    """Append-only scalar event writer (TensorBoard-compatible)."""

    def __init__(self, logdir):
        self.logdir = logdir
        os.makedirs(logdir, exist_ok=True)
        fname = 'events.out.tfevents.{0}.bmtpu'.format(int(time.time() * 1e6))
        self._path = os.path.join(logdir, fname)
        self._jsonl = os.path.join(logdir, 'scalars.jsonl')
        self._f = open(self._path, 'ab')
        self._j = open(self._jsonl, 'a')
        # records may arrive from the training thread and the async
        # checkpoint/summary worker concurrently; keep each record atomic
        self._lock = threading.Lock()
        # TensorBoard expects a version event first
        self._write_record(_pb_double(1, time.time()) +
                           _pb_bytes(3, b'brain.Event:2'))

    def _write_record(self, payload):
        header = struct.pack('<Q', len(payload))
        with self._lock:
            self._f.write(header)
            self._f.write(struct.pack('<I', _masked_crc(header)))
            self._f.write(payload)
            self._f.write(struct.pack('<I', _masked_crc(payload)))

    def add_scalar(self, tag, value, step):
        now = time.time()
        self._write_record(_encode_event(tag, value, step, now))
        line = json.dumps({'tag': tag, 'value': float(value),
                           'step': int(step), 'wall_time': now}) + '\n'
        with self._lock:
            self._j.write(line)

    def add_image(self, tag, img, step):
        """`img`: (H, W) or (H, W, 3) uint8 array (use
        plot_utils.im_reshape + dataset.im_rescale to build grids)."""
        from .png import encode_png
        import numpy as np
        img = np.asarray(img)
        png = encode_png(img)
        h, w = img.shape[:2]
        c = 1 if img.ndim == 2 else img.shape[2]
        self._write_record(_encode_image_event(tag, png, h, w, c, step,
                                               time.time()))

    def add_histogram(self, tag, values, step):
        self._write_record(_encode_histogram_event(tag, values, step,
                                                   time.time()))

    def add_histogram_raw(self, tag, edges, counts, vmin, vmax, num, vsum,
                          vsum_sq, step):
        """Histogram from precomputed buckets (len(edges) == len(counts)+1)
        -- lets callers reduce on an accelerator and ship only the buckets
        over slow device links."""
        self._write_record(_encode_histogram_from_buckets(
            tag, edges, counts, vmin, vmax, num, vsum, vsum_sq, step,
            time.time()))

    def add_device_histogram(self, tag, stats, step):
        """Consume a small bucketed histogram dict (``counts``, ``min``,
        ``max``, ``sum``, ``sum_sq``, ``n_nonfinite``)."""
        import numpy as np
        vmin, vmax = float(stats['min']), float(stats['max'])
        counts = np.asarray(stats['counts'])
        if vmax > vmin:
            edges = np.linspace(vmin, vmax, len(counts) + 1)
        else:  # degenerate (constant tensor): give TB strictly-increasing
               # edges around the single value
            eps = max(abs(vmin), 1.) * 1e-7
            edges = vmin + np.arange(len(counts) + 1) * eps
        num = int(counts.sum(dtype=np.int64))
        self.add_histogram_raw(tag, edges, counts, vmin, vmax, num,
                               float(stats['sum']),
                               float(stats['sum_sq']), step)
        n_bad = int(stats.get('n_nonfinite', 0))
        if n_bad:  # diverging run: surface the count instead of silently
                   # dropping the values from the histogram
            self.add_scalar(tag + '/n_nonfinite', n_bad, step)

    def flush(self):
        with self._lock:
            self._f.flush()
            self._j.flush()

    def close(self):
        self.flush()
        self._f.close()
        self._j.close()
