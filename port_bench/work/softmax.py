"""The work of a DBM's multinomial layer's rows (``dbm_softmax``), beside
the step's products and associations (``dbm_step_work``)."""

from . import F32, Work


def dbm_softmax_work(H, B, M, n_mf, k=1):
    """A DBM's multinomial layer of H units in one PCD step on B rows and M
    particles, as ``dbm_softmax`` runs it after the layer's product: the
    rows of the mean-field init and of `n_mf` sweeps (the pre-activations
    read, the means n softmax written; a sweep's rows also read the old
    means for the change) and of k Gibbs sweeps (the pre-activations
    read, the counts written); ~5 operations an entry (the max, the
    exponential, the sum, the quotient and the product by n).  The CDF
    and the draws are not counted."""
    rows = B * (1 + n_mf) + M * k
    return Work(0., 5. * rows * H,
                F32 * H * (2 * B + 3 * n_mf * B + 2 * k * M))
