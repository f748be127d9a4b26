"""Dataset loaders and image layout converters
(reference utils/dataset.py:10-195 equivalents).

`load_mnist`/`load_cifar10` read the same raw on-disk formats (IDX binaries,
CIFAR python pickle batches).  When the files are absent, callers can fall
back to `make_synthetic_mnist` for smoke runs on machines without the data.

Layout converters use the reference's channel-major flattening so learned
filters are binary-compatible for visualization.
"""

import os
import os.path
import pickle
import struct

import numpy as np

from .rng import RNG


def resolve_data_dir(path=None):
    """Data-root resolution: explicit argument > BMT_DATA_DIR environment
    variable > the repository's data/ directory.  The env hook points
    every loader, example, and quality-parity test at an offline dataset
    mirror without touching any call site."""
    if path:
        return path
    env = os.environ.get('BMT_DATA_DIR')
    if env:
        return env
    return os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), 'data')


def real_mnist_available(path=None):
    """True when the *genuine* MNIST IDX files are on disk: the first five
    training labels are 5, 0, 4, 1, 9, which distinguishes the real dataset
    from synthetic stand-ins written in the same IDX format."""
    try:
        dirpath = os.path.join(resolve_data_dir(path), 'mnist/')
        with open(os.path.join(dirpath, 'train-labels-idx1-ubyte'), 'rb') as f:
            f.read(8)
            first = np.frombuffer(f.read(5), np.uint8)
        return list(first) == [5, 0, 4, 1, 9]
    except (IOError, OSError, ValueError):
        return False


def real_cifar_available(path=None):
    """True when the genuine CIFAR-10 python batches are on disk: the
    first five labels of data_batch_1 are 6, 9, 9, 4, 1."""
    try:
        dirpath = os.path.join(resolve_data_dir(path),
                               'cifar-10-batches-py/')
        with open(os.path.join(dirpath, 'data_batch_1'), 'rb') as f:
            d = pickle.load(f, encoding='latin1')
        return list(d['labels'][:5]) == [6, 9, 9, 4, 1]
    except (IOError, OSError, ValueError, KeyError):
        return False


def load_mnist(mode='train', path=None):
    """Load MNIST from raw IDX files.

    Returns
    -------
    data : (n_samples, 784) np.ndarray, raw intensities in [0., 255.]
    target : (n_samples,) np.ndarray, zero-based integer labels
    """
    dirpath = os.path.join(resolve_data_dir(path), 'mnist/')
    if mode == 'train':
        fname_data = os.path.join(dirpath, 'train-images-idx3-ubyte')
        fname_target = os.path.join(dirpath, 'train-labels-idx1-ubyte')
    elif mode == 'test':
        fname_data = os.path.join(dirpath, 't10k-images-idx3-ubyte')
        fname_target = os.path.join(dirpath, 't10k-labels-idx1-ubyte')
    else:
        raise ValueError("`mode` must be 'train' or 'test'")

    # fast path: native C++ IDX decoder (utils/native.py); numpy fallback
    from .native import load_idx3, load_idx1
    data = load_idx3(fname_data, scale=1.0)
    target = load_idx1(fname_target)
    if data is not None and target is not None:
        return data.astype(float), target.astype(np.int32)

    with open(fname_data, 'rb') as fdata:
        magic, n_samples, n_rows, n_cols = struct.unpack('>IIII', fdata.read(16))
        data = np.fromfile(fdata, dtype=np.uint8)
        data = data.reshape(n_samples, n_rows * n_cols)

    with open(fname_target, 'rb') as ftarget:
        magic, n_samples = struct.unpack('>II', ftarget.read(8))
        # IDX1 labels are unsigned bytes; cast both code paths to int32 so
        # downstream dtype-sensitive code sees one type regardless of
        # whether the native loader is available
        target = np.fromfile(ftarget, dtype=np.uint8)

    return data.astype(float), target.astype(np.int32)


def load_cifar10(mode='train', path=None):
    """Load CIFAR-10 from python pickle batches.

    Returns
    -------
    data : (n_samples, 3072) np.ndarray, raw intensities in [0., 255.]
    target : (n_samples,) np.ndarray, zero-based integer labels
    """
    dirpath = os.path.join(resolve_data_dir(path), 'cifar-10-batches-py/')
    batch_size = 10000
    if mode == 'train':
        fnames = ['data_batch_{0}'.format(i) for i in range(1, 6)]
    elif mode == 'test':
        fnames = ['test_batch']
    else:
        raise ValueError("`mode` must be 'train' or 'test'")
    n_samples = batch_size * len(fnames)
    data = np.zeros(shape=(n_samples, 3 * 32 * 32), dtype=float)
    target = np.zeros(shape=(n_samples,), dtype=int)
    start = 0
    for fname in fnames:
        fname = os.path.join(dirpath, fname)
        with open(fname, 'rb') as fdata:
            d = pickle.load(fdata, encoding='latin1')
            data[start:(start + batch_size)] = np.asarray(d['data'])
            target[start:(start + batch_size)] = np.asarray(d['labels'])
        start += batch_size
    return data, target


def make_synthetic_mnist(n_samples=2048, seed=42):
    """Deterministic synthetic stand-in for MNIST (stripe/blob digits) for
    smoke-testing pipelines when the real IDX files are unavailable."""
    rng = RNG(seed)
    y = rng.randint(0, 10, size=n_samples)
    X = np.zeros((n_samples, 28, 28))
    for i in range(n_samples):
        c = y[i]
        img = np.zeros((28, 28))
        img[2 + c:26:max(1, c + 1), 4:24] = 200.
        img[4:24, 2 + c:26:max(2, 10 - c)] += 120.
        img += rng.rand(28, 28) * 64.
        X[i] = np.clip(img, 0., 255.)
    return X.reshape(n_samples, 784), y


def im_flatten(X):
    """Flatten a batch of 3-channel images channel-major for learning:
    (n, H, W, 3) -> (n, 3*H*W)."""
    X = np.asarray(X)
    if len(X.shape) == 3:
        X = np.expand_dims(X, 0)
    n_samples = X.shape[0]
    X = X.transpose(0, 3, 1, 2).reshape((n_samples, -1))
    if X.shape[0] == 1:
        X = X[0, ...]
    return X


def im_unflatten(X):
    """Inverse of `im_flatten`: (n, 3*D*D) -> (n, D, D, 3).

    Examples
    --------
    >>> X = np.random.rand(10, 3072); Y = X.copy()
    >>> np.testing.assert_allclose(X, im_flatten(im_unflatten(Y)))
    >>> X = np.random.rand(3072); Y = X.copy()
    >>> np.testing.assert_allclose(X, im_flatten(im_unflatten(Y)))
    >>> X = np.random.rand(7, 32, 32, 3); Y = X.copy()
    >>> np.testing.assert_allclose(X, im_unflatten(im_flatten(Y)))
    >>> X = np.random.rand(8, 8, 3); Y = X.copy()
    >>> np.testing.assert_allclose(X, im_unflatten(im_flatten(Y)))
    """
    X = np.asarray(X)
    if len(X.shape) == 1:
        X = np.expand_dims(X, 0)
    D = int(np.sqrt(X.shape[1] / 3))
    X = X.reshape((-1, 3, D, D)).transpose(0, 2, 3, 1)
    if X.shape[0] == 1:
        X = X[0, ...]
    return X


def im_rescale(X, mean=0., std=1.):
    """Unflatten and rescale each image to full [0, 255] uint8 range for
    visualization."""
    X = np.array(X, dtype=float)
    X *= std
    X += mean
    X -= X.min(axis=1)[:, np.newaxis]
    X /= np.ptp(X, axis=1)[:, np.newaxis]
    X = im_unflatten(X)
    X *= 255.
    return X.astype('uint8')


def get_cifar10_labels():
    return ['airplane', 'auto', 'bird', 'cat', 'deer',
            'dog', 'frog', 'horse', 'ship', 'truck']


def get_cifar10_label(index):
    return get_cifar10_labels()[index]


def plot_cifar10(X, y, samples_per_class=7, title='CIFAR-10 dataset',
                 title_params=None, imshow_params=None):
    import matplotlib.pyplot as plt

    title_params = title_params or {}
    title_params.setdefault('fontsize', 20)
    title_params.setdefault('y', 0.95)
    imshow_params = imshow_params or {}
    imshow_params.setdefault('interpolation', 'none')

    num_classes = 10
    for c in range(num_classes):
        idxs = np.flatnonzero(np.asarray(y) == c)
        idxs = RNG(seed=1337).choice(idxs, samples_per_class, replace=False)
        for i, idx in enumerate(idxs):
            plt_idx = i * num_classes + c + 1
            ax = plt.subplot(samples_per_class, num_classes, plt_idx)
            for side in ('bottom', 'top', 'left', 'right'):
                ax.spines[side].set_linewidth(2.)
            plt.tick_params(axis='both', which='both',
                            bottom=False, top=False, left=False, right=False,
                            labelbottom=False, labelleft=False, labelright=False)
            plt.imshow(np.asarray(X)[idx].astype('uint8'), **imshow_params)
            if i == 0:
                plt.title(get_cifar10_label(c))
    plt.suptitle(title, **title_params)
    plt.subplots_adjust(wspace=0, hspace=0)
