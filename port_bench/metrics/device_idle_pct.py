"""The share of the traced slices of the training window in which no
operation ran on the device: 1 - (the union of the device operations'
intervals) / (the slices' wall time without the profiler, from the
seconds an epoch of the untraced parts around them)."""

from port_bench.harness.readers import device_idle_pct as read  # noqa: F401

KERNELS = ()
