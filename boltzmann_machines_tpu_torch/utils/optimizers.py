"""Optimizers for discriminative fine-tuning (the JAX package's
``utils/optimizers.py``, reference MultiAdam).

`multi_adam` is Adam with per-parameter-group learning-rate multipliers
matched by parameter-path prefix -- used to fine-tune MLPs whose first layer
is warm-started from RBM/DBM weights (small multiplier on pretrained layers,
full rate on the new head).  In PyTorch it is a ``torch.optim.Adam`` with one
param group per multiplier; each group remembers its multiplier
(``'lr_multiplier'``), so that `set_learning_rate` can push a new base rate
to every group.
"""

import torch


def multiplier_of(path, lr_multipliers):
    """The multiplier of the parameter at `path` ('/'-joined): the value of
    the first key that is the whole path or a prefix of it at a segment
    boundary ('1' must not match '10/W'), else 1."""
    s = str(path)
    for key, value in dict(lr_multipliers or {}).items():
        key = str(key)
        if s == key or s.startswith(key + '/'):
            return value
    return 1.


def named_parameters(params):
    """(path, tensor) pairs of `params`: an ``nn.Module`` (its dotted names
    with '/' for '.'), or a nested dict / list of tensors (keys and indices
    joined with '/')."""
    if isinstance(params, torch.nn.Module):
        return [(name.replace('.', '/'), p)
                for name, p in params.named_parameters()]
    out = []

    def walk(prefix, node):
        if isinstance(node, dict):
            items = node.items()
        elif isinstance(node, (list, tuple)):
            items = enumerate(node)
        else:
            out.append(('/'.join(prefix), node))
            return
        for k, v in items:
            walk(prefix + [str(k)], v)

    walk([], params)
    return out


def multi_adam(params, learning_rate=0.001, lr_multipliers=None,
               b1=0.9, b2=0.999, eps=1e-8):
    """Adam with per-layer learning-rate multipliers.

    Parameters
    ----------
    params : nn.Module, or nested dict / list of tensors
        The parameters; a parameter's path is its '/'-joined name.
    lr_multipliers : dict[str, float]
        Maps parameter-path prefixes (e.g. 'dense_1') to multipliers.
        A parameter whose path starts with a key gets
        `learning_rate * multiplier`; others get `learning_rate`.

    Returns a ``torch.optim.Adam`` with one param group per multiplier, in
    order of first appearance.  It computes optax's ``scale_by_adam(b1, b2,
    eps, eps_root=0)`` followed by the scaling by ``-learning_rate *
    multiplier``: both moments bias-corrected, ``eps`` added to the square
    root of the corrected second moment.  ``weight_decay=0``,
    ``amsgrad=False`` and the single-tensor loop (``foreach`` and ``fused``
    off) make ``torch.optim.Adam`` that same update, up to float rounding.
    """
    groups = {}
    for path, p in named_parameters(params):
        m = float(multiplier_of(path, lr_multipliers))
        groups.setdefault(m, []).append(p)
    return torch.optim.Adam(
        [{'params': ps, 'lr': learning_rate * m, 'lr_multiplier': m}
         for m, ps in groups.items()],
        lr=learning_rate, betas=(b1, b2), eps=eps, weight_decay=0.,
        amsgrad=False, foreach=False, fused=False)


def set_learning_rate(optimizer, learning_rate):
    """Set every param group of a `multi_adam` optimizer to
    `learning_rate` times its multiplier."""
    for group in optimizer.param_groups:
        group['lr'] = learning_rate * group['lr_multiplier']


def scale_by_multipliers(updates, lr_multipliers, learning_rate):
    """Scale a nested dict / list of update tensors by ``-learning_rate *
    multiplier(path)``, keeping its structure (the JAX package's function
    of the same name, for updates computed outside an optimizer)."""
    def walk(prefix, node):
        if isinstance(node, dict):
            return {k: walk(prefix + [str(k)], v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(prefix + [str(i)], v)
                              for i, v in enumerate(node))
        return node * (-learning_rate * multiplier_of('/'.join(prefix),
                                                      lr_multipliers))

    return walk([], updates)


# alias matching the reference class name
MultiAdam = multi_adam
