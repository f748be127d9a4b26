"""The whole training step's share of the card's peak: the product
operations that the window's steps need (from their shapes, and the
mean-field sweeps the program logged) over the traced slices' wall time
without the profiler at TF32's 495 TFLOP/s."""

from port_bench.harness.readers import mfu_pct as read  # noqa: F401

KERNELS = ()
