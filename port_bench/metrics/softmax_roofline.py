"""A DBM's multinomial layer (``dbm_softmax``, the rows after the layer's
product: n softmax with the mean-field change, or the counts drawn) against
its roofline: the least time of the window's softmax rows
(``work.dbm_softmax_work``) over the kernel's device time."""

from port_bench.harness.readers import roofline_pct

KERNELS = ('dbm_softmax_kernel',)


def read(ctx):
    return roofline_pct(ctx, 'softmax', KERNELS)
