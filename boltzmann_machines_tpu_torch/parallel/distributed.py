"""Multi-process initialization on ``torch.distributed``.

The counterpart of the JAX package's ``parallel/distributed.py``.  Call
``initialize`` once per process before building models.  Nothing on a host
tells a process about its peers, so the caller gives the rendezvous
(``init_method``: ``tcp://host:port``, ``file:///path``, or ``env://`` with
the usual MASTER_ADDR / MASTER_PORT / WORLD_SIZE / RANK variables), the
world size and the rank.  One process drives one device: with NCCL, rank r
takes CUDA device ``r % device_count``.
"""

import torch
import torch.distributed as dist


def initialize(init_method=None, world_size=None, rank=None, backend=None):
    """Thin wrapper over ``torch.distributed.init_process_group``.

    `backend` defaults to 'nccl' (the GPUs' collectives); 'gloo' runs on
    CPU tensors and is used only when asked for.  Returns the JAX
    package's keys: this process's index and count, its local devices, and
    the devices of the whole group (one per process)."""
    backend = backend or 'nccl'
    kwargs = {}
    if init_method is not None:
        kwargs['init_method'] = init_method
    if world_size is not None:
        kwargs['world_size'] = int(world_size)
    if rank is not None:
        kwargs['rank'] = int(rank)
    dist.init_process_group(backend=backend, **kwargs)
    if backend == 'nccl':
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    return {
        'process_index': dist.get_rank(),
        'process_count': dist.get_world_size(),
        'local_devices': (torch.cuda.device_count()
                          if torch.cuda.is_available() else 1),
        'global_devices': dist.get_world_size(),
    }


def process_local_slice(n_rows):
    """Row range [start, stop) of a globally (row-)sharded array that this
    process should materialize locally."""
    count, index = dist.get_world_size(), dist.get_rank()
    per = n_rows // count
    start = per * index
    stop = n_rows if index == count - 1 else start + per
    return start, stop
