"""The work of the CD kernels' softmax rows (``cd_softmax_sample``: a
multinomial hidden layer's pass after its product), beside the step's
products and associations (``cd_step_work``)."""

from . import F32, Work


def cd_softmax_work(H, rows, draws, n):
    """`rows` softmax rows of H units, `draws` draws among them (n a row
    that draws counts; 0 where a row writes its means alone), as the port
    counts them (``cd_epoch.softmax_rows``): every row reads its H
    pre-activations and writes its H means n softmax, a row that draws
    writes its H counts too; ~5 operations an entry (the max, the
    exponential, the sum, the quotient and the product by n).  The CDF and
    the draws are not counted."""
    drawn = draws / n if n else 0.
    return Work(0., 5. * rows * H, F32 * H * (2. * rows + drawn))
