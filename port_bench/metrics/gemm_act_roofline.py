"""The products with an activation epilogue (the CD and DBM steps'
``*_gemm_act`` kernels) against their roofline: the least time of the
window's products on the card over the device time of these kernels."""

from port_bench.harness.readers import roofline_pct

KERNELS = ('cd_gemm_act_kernel', 'dbm_gemm_act_kernel')


def read(ctx):
    return roofline_pct(ctx, 'gemm_act', KERNELS)
