"""The association update (``cd_assoc_update`` / ``dbm_assoc_update``, the
``assoc_kernel``) against its roofline: the least time of the window's
association products and momentum updates over the kernel's device
time."""

from port_bench.harness.readers import roofline_pct

KERNELS = ('assoc_kernel',)


def read(ctx):
    return roofline_pct(ctx, 'assoc', KERNELS)
