"""Iteration helpers, schedule coercion, one-hot trio, and numerically
stable log-space math (reference utils/utils.py:10-170 equivalents).

The log-*-exp family is used by AIS run aggregation and is implemented in
numpy (host-side aggregation of per-run estimates); device-side reductions
use torch equivalents on the model's device.
"""

import numpy as np

try:
    from tqdm import tqdm
    _HAVE_TQDM = True
except ImportError:  # pragma: no cover
    _HAVE_TQDM = False


def write_during_training(s):
    if _HAVE_TQDM:
        tqdm.write(s)
    else:  # pragma: no cover
        print(s)


def batch_iter(X, batch_size=10, verbose=False, desc='epoch'):
    """Divide input data into batches, with optional progress bar.

    Examples
    --------
    >>> X = np.arange(36).reshape((12, 3))
    >>> [len(b) for b in batch_iter(X, batch_size=5)]
    [5, 5, 2]
    >>> [b[0, 0] for b in batch_iter(X, batch_size=5)]
    [np.int64(0), np.int64(15), np.int64(30)]
    """
    X = np.asarray(X)
    N = len(X)
    n_batches = N // batch_size + (N % batch_size > 0)
    gen = range(n_batches)
    if verbose and _HAVE_TQDM:
        gen = tqdm(gen, leave=False, ncols=64, desc=desc)
    for i in gen:
        yield X[i * batch_size:(i + 1) * batch_size]


def epoch_iter(start_epoch, max_epoch, verbose=False):
    gen = range(start_epoch + 1, max_epoch + 1)
    if verbose and _HAVE_TQDM:
        gen = tqdm(gen, leave=True, ncols=84, desc='training')
    for epoch in gen:
        yield epoch


def make_list_from(x):
    """Coerce scalar-or-iterable hyperparameters to a schedule list.

    >>> make_list_from(3)
    [3]
    >>> make_list_from([1, 2])
    [1, 2]
    """
    return list(x) if hasattr(x, '__iter__') else [x]


def schedule_value(schedule, epoch):
    """Per-epoch schedule lookup with last-value clamping
    (reference base_rbm.py:535-541 semantics)."""
    return schedule[min(epoch, len(schedule) - 1)]


def one_hot(y, n_classes=None):
    """Convert `y` to one-hot encoding.

    >>> one_hot([2, 1, 0, 2, 0])
    array([[0., 0., 1.],
           [0., 1., 0.],
           [1., 0., 0.],
           [0., 0., 1.],
           [1., 0., 0.]])
    """
    y = np.asarray(y, dtype=int)
    n_classes = n_classes or np.max(y) + 1
    return np.eye(n_classes)[y]


def one_hot_decision_function(y):
    """
    >>> one_hot_decision_function([[0.1, 0.4, 0.5], [0.8, 0.1, 0.1]])
    array([[0., 0., 1.],
           [1., 0., 0.]])
    """
    y = np.asarray(y)
    z = np.zeros_like(y)
    z[np.arange(len(z)), np.argmax(y, axis=1)] = 1
    return z


def unhot(y, n_classes=None):
    """Map `y` from one-hot encoding to {0, ..., n_classes - 1}.

    >>> unhot([[0, 0, 1], [0, 1, 0], [1, 0, 0]])
    array([2, 1, 0])
    """
    y = np.asarray(y)
    if not n_classes:
        _, n_classes = y.shape
    return y.dot(np.arange(n_classes))


def log_sum_exp(x):
    """Compute log(sum(exp(x))) in a numerically stable way.

    >>> print('%.3f' % log_sum_exp([0, 1, 0]))
    1.551
    >>> print('%.3f' % log_sum_exp([1000, 1001, 1000]))
    1001.551
    >>> print('%.3f' % log_sum_exp([-1000, -999, -1000]))
    -998.449
    """
    x = np.asarray(x)
    a = x.max()
    return a + np.log(np.sum(np.exp(x - a)))


def log_mean_exp(x):
    """Compute log(mean(exp(x))) in a numerically stable way.

    >>> print('%.4f' % log_mean_exp([1, 2, 3]))
    2.3090
    """
    return log_sum_exp(x) - np.log(len(x))


def log_diff_exp(x):
    """Compute log(diff(exp(x))) in a numerically stable way.

    >>> np.round(log_diff_exp([1, 2, 3]), 4)
    array([1.5413, 2.5413])
    """
    x = np.asarray(x)
    a = x.max()
    return a + np.log(np.diff(np.exp(x - a)))


def log_std_exp(x, log_mean_exp_x=None):
    """Compute log(std(exp(x))) in a numerically stable way.

    >>> x = np.arange(8.)
    >>> print('%.5f' % log_std_exp(x))
    5.87542
    >>> print('%.5f' % np.log(np.std(np.exp(x))))
    5.87542
    """
    x = np.asarray(x)
    m = log_mean_exp_x
    if m is None:
        m = log_mean_exp(x)
    M = log_mean_exp(2. * x)
    return 0.5 * log_diff_exp([2. * m, M])[0]
