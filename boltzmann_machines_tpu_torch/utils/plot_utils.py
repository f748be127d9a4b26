"""Image-grid plotting, filter-evolution GIFs, confusion matrices: a copy
of the JAX package's ``utils/plot_utils.py`` (reference
utils/plot_utils.py:7-151 equivalents), numpy only; matplotlib is imported
lazily so headless training never touches it."""

import numpy as np


def filter_grid_image(W, v_shape, n_filters):
    """Tile the first `n_filters` weight columns of W (V, H) into one
    contrast-normalized uint8 grid image shaped by `v_shape` = (h, w, c).
    Matplotlib-free (feeds the TensorBoard image summaries)."""
    h, w, c = v_shape
    n = min(n_filters, W.shape[1])
    side = int(np.ceil(np.sqrt(n)))
    F = np.zeros((side * side, h, w, c), dtype=np.float32)
    for i in range(n):
        f = np.asarray(W[:, i], dtype=np.float32)
        if c == 3:
            # channel-major flattening (dataset.im_unflatten layout)
            f = f.reshape(c, h, w).transpose(1, 2, 0)
        else:
            f = f.reshape(h, w, c)
        lo, hi = f.min(), f.max()
        F[i] = (f - lo) / max(hi - lo, 1e-8)
    grid = im_reshape(F, n_width=side, n_height=side, shape=(h, w, c))
    img = (np.clip(grid, 0., 1.) * 255.).astype(np.uint8)
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[:, :, 0]
    return img


def tick_params():
    """Tick params to plot images without labels or borders."""
    return dict(axis='both', which='both',
                bottom=False, top=False, left=False, right=False,
                labelbottom=False, labelleft=False, labelright=False)


def im_plot(X, n_width=10, n_height=10, shape=None, title=None,
            title_params=None, imshow_params=None):
    """Plot a batch of images `X` on a single grid figure."""
    from matplotlib import pyplot as plt

    X = np.asarray(X)
    if shape is None:
        shape = X.shape[1:]

    title_params = title_params or {}
    title_params.setdefault('fontsize', 22)
    title_params.setdefault('y', 0.95)
    imshow_params = imshow_params or {}
    imshow_params.setdefault('interpolation', 'nearest')

    for i in range(n_height * n_width):
        if i < len(X):
            img = X[i]
            if shape is not None:
                img = img.reshape(shape)
            ax = plt.subplot(n_height, n_width, i + 1)
            for d in ('bottom', 'top', 'left', 'right'):
                ax.spines[d].set_linewidth(2.)
            plt.tick_params(**tick_params())
            plt.imshow(img, **imshow_params)
    if title:
        plt.suptitle(title, **title_params)
    plt.subplots_adjust(wspace=0, hspace=0)


def im_reshape(X, n_width=10, n_height=10, shape=None, normalize=False):
    """Tile a batch of images into one grid image.

    Returns (n_height*h, n_width*w[, c]) array.

    Examples
    --------
    >>> X = np.arange(4 * 6).reshape(4, 2, 3).astype(float)
    >>> im_reshape(X, n_width=2, n_height=2).shape
    (4, 6)
    """
    X = np.asarray(X)
    if shape is None:
        shape = X.shape[1:]

    Y = X[:(n_width * n_height), ...].copy()
    if len(shape) == 2:
        shape = (shape[0], shape[1], 1)
    Y = Y.reshape(-1, *shape)
    Z = np.zeros((n_height * shape[0], n_width * shape[1], shape[2]),
                 dtype=Y.dtype)

    for i in range(n_height):
        for j in range(n_width):
            ind = n_height * i + j
            if ind < len(Y):
                Y_i = Y[ind, ...]
                if normalize:
                    Y_i = Y_i - Y_i.min()
                    Y_i = Y_i / max(np.ptp(Y_i), 1e-5)
                    Y_i = Y_i / Y_i.max()
                Z[i * shape[0]:(i + 1) * shape[0],
                  j * shape[1]:(j + 1) * shape[1], ...] = Y_i
    if Z.shape[2] == 1:
        Z = Z[:, :, 0]
    return Z


def im_gif(matrices, im, fig, fname=None, title_func=None,
           title_params=None, anim_params=None, save_params=None):
    """Animate a list of grid images (e.g. filter evolution over epochs)."""
    from matplotlib.animation import FuncAnimation

    if title_func is None:
        title_func = lambda i: str(i)

    title_params = title_params or {}
    title_params.setdefault('fontsize', 18)
    anim_params = anim_params or {}
    anim_params.setdefault('interval', 250)
    anim_params.setdefault('blit', True)
    save_params = save_params or {}
    save_params.setdefault('dpi', 80)
    save_params.setdefault('writer', 'imagemagick')

    def init():
        im.set_array([[]])
        return im,

    def animate(i):
        im.set_array(matrices[i])
        im.axes.set_title(title_func(i), **title_params)
        return im,

    anim = FuncAnimation(fig, animate, init_func=init,
                         frames=len(matrices), **anim_params)
    if fname:
        anim.save(fname, **save_params)
    return anim


def plot_confusion_matrix(C, labels=None, labels_fontsize=13,
                          **heatmap_params):
    """Annotated confusion-matrix heatmap."""
    from matplotlib import pyplot as plt
    try:
        import seaborn as sns
        have_sns = True
    except ImportError:
        have_sns = False

    C = np.asarray(C)
    labels = labels if labels is not None else list(range(C.shape[0]))
    heatmap_params.setdefault('annot', True)
    heatmap_params.setdefault(
        'fmt', 'd' if np.issubdtype(C.dtype, np.integer) else '.3f')
    heatmap_params.setdefault('annot_kws', {'size': 14})
    heatmap_params['annot_kws'].setdefault('size', 14)
    heatmap_params.setdefault('xticklabels', labels)
    heatmap_params.setdefault('yticklabels', labels)

    with plt.rc_context(rc={'xtick.labelsize': labels_fontsize,
                            'ytick.labelsize': labels_fontsize}):
        if have_sns:
            ax = sns.heatmap(C, **heatmap_params)
        else:  # matplotlib-only fallback
            fig, ax = plt.subplots()
            ax.imshow(C, cmap='Blues')
            for i in range(C.shape[0]):
                for j in range(C.shape[1]):
                    ax.text(j, i, format(C[i, j],
                                         heatmap_params['fmt']),
                            ha='center', va='center')
        plt.xlabel('predicted', fontsize=21)
        plt.ylabel('actual', fontsize=21)
        return ax
