"""The CD kernels' softmax rows (``cd_softmax_sample``: a multinomial hidden
layer's means n softmax and counts, after the layer's product, in the
epoch's chain and in the whole-set passes) against their roofline: the
least time of the window's softmax rows (``work.cd_softmax.
cd_softmax_work``, on the rows the port counted) over the kernel's device
time.  None where the port counts no softmax rows."""

from port_bench.harness.readers import roofline_pct

KERNELS = ('cd_softmax_sample_kernel',)


def read(ctx):
    return roofline_pct(ctx, 'cd_softmax', KERNELS)
