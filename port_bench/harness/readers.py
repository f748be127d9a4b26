"""The arithmetic of the per-layer metrics, shared by the reader files
under ``metrics/`` (one file a metric, each naming its kernels).  Each
returns None where the window holds nothing to read."""

from ..work import PEAK_TF32


def wall_s(ctx):
    """The traced slices' seconds without the profiler, which lengthens
    them by its work at every launch: the seconds of the timed parts
    beside them, each as many epochs as its slice; the traced length
    where a piece has no timed part."""
    untraced = ctx.window.get('untraced_s')
    return untraced if untraced else ctx.trace.window_s


def device_idle_pct(ctx):
    """1 - (the union of the device operations' intervals) / (the traced
    slices' wall time without the profiler), in %."""
    if not ctx.trace.device or wall_s(ctx) <= 0:
        return None
    return 100. * (1. - ctx.trace.busy_s() / wall_s(ctx))


def mfu_pct(ctx):
    """The product operations the traced slices' steps need over their
    wall time without the profiler at TF32's peak, in %."""
    if wall_s(ctx) <= 0 or not ctx.work:
        return None
    products = sum(w.products for w in ctx.work.values())
    return 100. * products / (wall_s(ctx) * PEAK_TF32)


def roofline_pct(ctx, group, kernels):
    """The least time of the window's work of kernel group `group` on the
    card over the device time of `kernels`, in %."""
    t = ctx.trace.kernel_seconds(kernels)
    if t <= 0 or group not in ctx.work:
        return None
    return 100. * ctx.work[group].least_seconds() / t


def launches_per_step(ctx):
    """The port's launch counters' growth over the window a step."""
    steps = ctx.window['steps']
    if not steps:
        return None
    return sum(ctx.launches.values()) / steps
