"""A 2-D mesh of ``torch.distributed`` process groups: ('data', 'model').

The counterpart of the JAX package's ``parallel/mesh.py``.  Each process
(rank) drives one device.  Along the ``data`` axis minibatch rows,
persistent particles and AIS runs are split over the ranks and the
statistics summed by ``all_reduce``; along the ``model`` axis the hidden
columns of W (and the hidden biases and accumulators) are split over the
ranks -- tensor parallelism, ``model.set_mesh(mesh, model_axis='model')``.
By default every rank lies on the data axis and the model axis has size 1.

Ranks are laid out row-major, as JAX lays out its device array: the rank
r of the mesh's group has data index ``r // M`` and model index ``r % M``
on a (D, M) mesh.  One group is built per axis line, by every rank, in the
same order; an axis that spans the whole group keeps that group, and a
model axis of size 1 has none (nothing is reduced over it), so the default
mesh builds no group.  A process that built a 2-D mesh ends with
``torch.distributed.destroy_process_group()``.
"""

import torch
import torch.distributed as dist

DATA_AXIS, MODEL_AXIS = 'data', 'model'


class Mesh(object):
    """The ranks of `group` (None: the default group) as a (D, M) mesh.

    ``group``, ``rank`` and ``size`` are this process's data axis (the
    group of the ranks that hold the same hidden columns); ``model_group``,
    ``model_rank`` and ``model_size`` its model axis (the ranks that share
    its rows; no group at size 1); ``global_rank`` its rank in the mesh's
    group (its global rank when the mesh spans the default group);
    ``shape`` maps each axis name to its size."""

    def __init__(self, shape, axis_names, group=None):
        if not dist.is_initialized():
            raise RuntimeError('torch.distributed is not initialized: call '
                               'parallel.initialize(...) first')
        n = dist.get_world_size(group)
        if len(axis_names) not in (1, 2) or len(shape) != len(axis_names):
            raise ValueError('a mesh has one or two axes, named: got shape '
                             '{0} for axes {1}'.format(shape, axis_names))
        shape = tuple(int(s) for s in shape) + (1,) * (2 - len(shape))
        if shape[0] * shape[1] != n:
            raise ValueError('mesh shape {0} does not match {1} ranks'
                             .format(shape, n))
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, shape))
        self.world_group = group
        self.global_rank = dist.get_rank(group)
        D, M = shape
        self.rank, self.model_rank = divmod(self.global_rank, M)
        self.size, self.model_size = D, M
        if M == 1:
            self.group, self.model_group = group, None
            return
        ranks = (list(range(n)) if group is None
                 else dist.get_process_group_ranks(group))
        me = ranks[self.global_rank]

        def axis_group(lines):
            # every rank builds every line's group, in the same order
            mine = None
            for line in lines:
                g = group if len(line) == n else dist.new_group(line)
                if me in line:
                    mine = g
            return mine
        self.group = axis_group([[ranks[d * M + m] for d in range(D)]
                                 for m in range(M)])
        self.model_group = axis_group([[ranks[d * M + m] for m in range(M)]
                                       for d in range(D)])

    def src(self):
        """The global rank of the data group's rank 0."""
        return 0 if self.group is None else dist.get_global_rank(self.group,
                                                                 0)

    def world_src(self):
        """The global rank of the mesh group's rank 0."""
        return 0 if self.world_group is None else \
            dist.get_global_rank(self.world_group, 0)


def make_mesh(shape=None, axis_names=(DATA_AXIS, MODEL_AXIS), group=None):
    """The (D, M) mesh over the ranks of `group` (default: the default
    group).  `shape` None puts every rank on the leading ('data') axis; a
    shape whose product is not the group's size raises ``ValueError``."""
    if not dist.is_initialized():
        raise RuntimeError('torch.distributed is not initialized: call '
                           'parallel.initialize(...) first')
    if shape is None:
        shape = (dist.get_world_size(group),) + (1,) * (len(axis_names) - 1)
    return Mesh(shape, axis_names, group)


def shard_batch(mesh, X):
    """This rank's rows of a (batch, ...) array: the contiguous block
    ``[rank b, (rank + 1) b)`` with ``b = batch / size`` (the data axis)."""
    n = X.shape[0]
    if n % mesh.size:
        raise ValueError('{0} rows do not split over {1} ranks'.format(
            n, mesh.size))
    b = n // mesh.size
    return X[mesh.rank * b:(mesh.rank + 1) * b]


def column_blocks(n, parts):
    """The [start, stop) ranges of `n` columns split over `parts` ranks:
    ``torch.tensor_split``'s blocks, the first ``n % parts`` one column
    wider, so that any n splits.  Every slice and gather of a
    tensor-parallel model takes its blocks from here."""
    per, extra = divmod(int(n), int(parts))
    starts = [i * per + min(i, extra) for i in range(parts + 1)]
    return [(starts[i], starts[i + 1]) for i in range(parts)]


def column_block(mesh, n):
    """This rank's [start, stop) of `n` columns on the model axis."""
    return column_blocks(n, mesh.model_size)[mesh.model_rank]


def shard_model_columns(mesh, W, axis=MODEL_AXIS):
    """This rank's block of the last dimension of `W` (a (in, out) weight
    matrix's output columns, or a vector of hidden units) on the model
    axis (``column_blocks``)."""
    if axis != mesh.axis_names[-1] or len(mesh.axis_names) != 2:
        raise ValueError('the mesh has no model axis {0!r}'.format(axis))
    start, stop = column_block(mesh, W.shape[-1])
    return W[..., start:stop]


def replicate(mesh, tree, axis=None):
    """Broadcast every tensor of a dict / list / tuple tree in place, so
    that every rank holds the same values; returns the tree.  `axis` None
    broadcasts from the mesh's rank 0 over all its ranks; 'data' from the
    data group's rank 0 over the data group (the ranks that hold the same
    column block of a tensor-parallel model)."""
    if axis is None:
        src, group = mesh.world_src(), mesh.world_group
    else:
        src, group = mesh.src(), mesh.group
    if isinstance(tree, torch.Tensor):
        dist.broadcast(tree, src=src, group=group)
    elif isinstance(tree, dict):
        for v in tree.values():
            replicate(mesh, v, axis)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            replicate(mesh, v, axis)
    return tree


def all_gather_rows(mesh, x):
    """The rows of every rank's `x` (each rank's the same shape), stacked in
    data-rank order, on every rank: one all_reduce(SUM) over the data group
    of a zero buffer holding this rank's rows at its place (exact, as each
    element adds zeros to one value), so that it runs on any backend and
    device."""
    n = x.shape[0]
    out = torch.zeros((mesh.size * n,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    out[mesh.rank * n:(mesh.rank + 1) * n] = x
    dist.all_reduce(out, group=mesh.group)
    return out


def all_gather_columns(mesh, x, n):
    """The whole `n` columns (last dimension) of a tensor whose blocks
    (``column_blocks``) the model axis's ranks hold, on every rank of it:
    one all_reduce(SUM) over the model group of a zero buffer holding this
    rank's block at its place, exact on any backend and device (gloo on
    CUDA tensors too)."""
    if mesh.model_size == 1:
        return x
    start, stop = column_block(mesh, n)
    out = torch.zeros(tuple(x.shape[:-1]) + (n,), dtype=x.dtype,
                      device=x.device)
    out[..., start:stop] = x
    dist.all_reduce(out, group=mesh.model_group)
    return out
