"""Kernel launches a training step, from the port's own launch counters
(``cd_epoch.launches``, ``dbm_epoch.launches``) over the window: an exact
count."""

from port_bench.harness.readers import launches_per_step as read  # noqa: F401

KERNELS = ()
