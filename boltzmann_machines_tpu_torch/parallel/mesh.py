"""A data-parallel mesh over a ``torch.distributed`` process group.

The counterpart of the JAX package's ``parallel/mesh.py``, for its
``data`` axis: each process (rank) drives one device and holds a full
replica of the model; minibatch rows are split over the ranks, and the
gradient statistics are summed across them by ``all_reduce``.  Models take
a mesh through ``model.set_mesh(make_mesh())``.  The ``model`` axis
(hidden columns of W split over devices) is not ported (ROADMAP.md Queue
A9).
"""

import torch
import torch.distributed as dist

DATA_AXIS = 'data'


class Mesh(object):
    """The ranks of `group` (None: the default group) along one axis,
    'data'; `rank` and `size` are this process's place in it."""

    axis_names = (DATA_AXIS,)

    def __init__(self, group=None):
        if not dist.is_initialized():
            raise RuntimeError('torch.distributed is not initialized: call '
                               'parallel.initialize(...) first')
        self.group = group
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)

    def src(self):
        """The global rank of the group's rank 0."""
        return 0 if self.group is None else dist.get_global_rank(self.group,
                                                                 0)


def make_mesh(group=None):
    """The data-parallel mesh of `group` (default: the default group)."""
    return Mesh(group)


def shard_batch(mesh, X):
    """This rank's rows of a (batch, ...) array: the contiguous block
    ``[rank b, (rank + 1) b)`` with ``b = batch / size``."""
    n = X.shape[0]
    if n % mesh.size:
        raise ValueError('{0} rows do not split over {1} ranks'.format(
            n, mesh.size))
    b = n // mesh.size
    return X[mesh.rank * b:(mesh.rank + 1) * b]


def shard_model_columns(mesh, W, axis='model'):
    raise NotImplementedError('tensor-parallel W (hidden columns split over '
                              'devices) is not ported yet (ROADMAP.md Queue '
                              'A9)')


def replicate(mesh, tree):
    """Broadcast every tensor of a dict / list / tuple tree from the
    group's rank 0, in place, so that every rank holds the same values;
    returns the tree."""
    if isinstance(tree, torch.Tensor):
        dist.broadcast(tree, src=mesh.src(), group=mesh.group)
    elif isinstance(tree, dict):
        for v in tree.values():
            replicate(mesh, v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            replicate(mesh, v)
    return tree
