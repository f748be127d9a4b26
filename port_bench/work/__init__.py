"""The card's published peaks and the work of each step, from shapes.

The peaks are NVIDIA's data sheet for the H100 SXM part (dense rates, at
its 700 W limit; the run prints the card's own power limit beside every
reading).  Products count at TF32's rate, 495 TFLOP/s, and not at the
165 TFLOP/s of the 3xTF32 scheme the port's kernels use today: 3xTF32 is
one way to implement a float32 product, not a peak of the card.  The
sampled states of CD and PCD are exactly 0 or 1, which TF32 holds exactly,
so a sound kernel could reach float32 accuracy with fewer splits, and a
share counted against 165 could then pass 100%.  Nothing computed in TF32
or above can pass 495.

Every count is the work that the inputs need: each input read once, each
output written once, whatever a kernel reads again.
"""

PEAK_TF32 = 495e12      # FLOP/s, products on the tensor cores
PEAK_FP32 = 67e12       # FLOP/s, other float32 work
PEAK_BYTES = 3.35e12    # bytes/s, HBM3
F32 = 4                 # bytes


class Work(object):
    """Product operations, other float32 operations and bytes."""

    __slots__ = ('products', 'flops', 'bytes')

    def __init__(self, products=0., flops=0., nbytes=0.):
        self.products, self.flops, self.bytes = (float(products),
                                                 float(flops), float(nbytes))

    def __add__(self, other):
        return Work(self.products + other.products, self.flops + other.flops,
                    self.bytes + other.bytes)

    def __mul__(self, n):
        return Work(self.products * n, self.flops * n, self.bytes * n)

    __rmul__ = __mul__

    def least_seconds(self):
        """The least time of this work on the card: operations (products at
        the TF32 peak plus other float32 work at its peak) or bytes,
        whichever is longer."""
        ops = self.products / PEAK_TF32 + self.flops / PEAK_FP32
        return max(ops, self.bytes / PEAK_BYTES)


def product(M, K, N, outputs=1, bias=True):
    """An (M, K) x (K, N) product with an activation epilogue: 2 M K N
    operations; A and W read, `outputs` (M, N) results (means, states)
    and the bias."""
    return Work(2. * M * K * N, 0.,
                F32 * (M * K + K * N + outputs * M * N + (N if bias else 0)))


def cd_step_work(V, H, B, k=1, sample_h=True, sample_v=False):
    """One CD-k step of a Bernoulli RBM on B rows, split as the kernels
    split it: ``gemm_act`` (the 1 + 2k products with their activations and
    draws) and ``assoc`` (the two association products X^T h0 and
    v^T h, and the momentum update of W: ~8 operations a weight; X, h0,
    v, h, W and dW read, W and dW written).  The bias statistics and the
    Philox draws are not counted."""
    gemm = product(B, V, H, 2 if sample_h else 1)
    for _ in range(k):
        gemm = gemm + product(B, H, V, 2 if sample_v else 1) + \
            product(B, V, H, 2 if sample_h else 1)
    assoc = Work(2 * 2. * B * V * H, 8. * V * H,
                 F32 * (2 * B * (V + H) + 4 * V * H))
    return {'gemm_act': gemm, 'assoc': assoc}


def dbm_step_work(V, H1, H2, B, M, n_mf, k=1):
    """One PCD step of a two-layer DBM on B rows and M particles, split as
    the kernels split it: ``gemm_act`` (X.W0, the init of mu1, `n_mf`
    mean-field sweeps of two products, k Gibbs sweeps of four, the
    reconstruction) and ``assoc`` (data and particle associations of both
    layers and the momentum update, ~8 operations a weight)."""
    gemm = product(B, V, H1, bias=False) + product(B, H1, H2)
    gemm = gemm + n_mf * (product(B, H2, H1) + product(B, H1, H2))
    for _ in range(k):
        gemm = gemm + (product(M, V, H1, 2) + product(M, H2, H1, 0, False) +
                       product(M, H1, H2, 2) + product(M, H1, V, 2))
    gemm = gemm + product(B, H1, V)
    assoc = Work()
    for K, N in ((V, H1), (H1, H2)):
        assoc = assoc + Work(2. * (B + M) * K * N, 8. * K * N,
                             F32 * ((B + M) * (K + N) + 4 * K * N))
    return {'gemm_act': gemm, 'assoc': assoc}


def ais_beta_work(V, H1, H2, R, k):
    """One beta of AIS on R runs: k transitions of three products and the
    two products of the log-weight, W read once, the runs' states in and
    out."""
    a, b = V * H1, H1 * H2
    return {'gemm_act': Work((4. * k + 2.) * R * (a + b), 0.,
                             F32 * ((a + b) + 2 * R * H1))}
