"""Per-shard CD-k statistics of the data-parallel RBM epoch.

Port of the TPU's ``make_cd_stats_kernel`` / ``_cd_stats_kernel``
(boltzmann_machines_tpu/ops/pallas_ops.py:1206, body :1086-1151;
``pallas_call`` at :1238) and of its W-streaming twin
``make_tiled_cd_stats_kernel`` / ``_tiled_cd_stats_kernel`` (:991, body
:840-988; ``pallas_call`` at :1033), which computes the same function for a
W too big for VMEM.  On Hopper that is no special case, so both names build
the same op, with the contract of ``pallas_ops.py:1211-1215``::

    stats_fn = make_cd_stats_kernel(n_visible, n_hidden, batch_size, k,
                                    sample_v_states, sample_h_states,
                                    propup_mult, propdown_mult,
                                    visible='bernoulli', sigma=None)
    stats, aux = stats_fn(state, X_local, seed, it, shard, out=None)

`stats` holds the raw sums of the local minibatch -- ``assoc`` (V, H),
``dvb_sum`` (V,), ``dhb_sum`` and ``h_sum`` (H,) -- whose sum over the ranks
is the whole batch's (``BaseRBM._cd_stats``); `aux` is {X, v_means} for the
metrics.  The four sums are views of one flat float32 buffer ``[assoc |
dvb_sum | dhb_sum | h_sum]`` (``stats_buffer``), written in place, so the
epoch all-reduces them as one block; `out` passes a buffer to reuse.
Visible units are Bernoulli or Gaussian (scalar or per-unit sigma, inputs
already divided by it), hidden units Bernoulli.  At k = 0 both versions
follow the TPU kernels (pallas_ops.py:1132-1134, :926-928): v_states =
v_means = X and h_means = h0, so every sum but h_sum is zero (ROADMAP.md
Queue C1).

Draws: key (seed, it), counter (element index within the local batch,
stream, shard, 0); at shard 0 exactly the epoch kernels' draws
(``ops/philox.py``).

Three parts, as in ``ops/cd_epoch.py``: ``cd_stats_reference`` (plain
PyTorch), ``cd_stats`` (a CPU tensor runs the plain version, a CUDA tensor
launches ``cd_gemm_act`` 1 + 2k times, then ``cd_stats_sums`` and
``cd_assoc_stats`` of ``csrc/cd_epoch.cu``, or raises) and
``cd_stats.launches``.
"""

from collections import namedtuple

import torch

from .cd_epoch import (_launch_h_pass, _launch_v_pass, check_flavour,
                       check_launch, check_tensors, h_means_reference,
                       h_sample_reference, library, ptr, sigma_row,
                       v_means_reference, v_sample_reference)
from .philox import STREAM_H0, stream_h, stream_v

KERNELS = ('cd_gemm_act', 'cd_stats_sums', 'cd_assoc_stats')

CDStatsConfig = namedtuple('CDStatsConfig', (
    'n_visible', 'n_hidden', 'k', 'sample_v_states', 'sample_h_states',
    'propup_mult', 'propdown_mult', 'visible', 'sigma', 'hidden',
    'n_samples'), defaults=('bernoulli', None))


def make_cd_stats_kernel(n_visible, n_hidden, batch_size, k,
                         sample_v_states, sample_h_states,
                         propup_mult, propdown_mult,
                         visible='bernoulli', sigma=None):
    """Build ``stats(state, X_local, seed, it, shard, out=None)`` with the
    static configuration of the JAX factory (see the module docstring).
    `batch_size` (the local batch) is kept for that signature; the op takes
    any row count."""
    check_flavour(visible, 'bernoulli', None)
    if int(k) < 0:
        raise ValueError('need k >= 0')
    cfg = CDStatsConfig(int(n_visible), int(n_hidden), int(k),
                        bool(sample_v_states), bool(sample_h_states),
                        float(propup_mult), float(propdown_mult), visible,
                        sigma if visible == 'gaussian' else None)

    def stats(state, X_local, seed, it, shard, out=None):
        return cd_stats(cfg, state, X_local, seed, it, shard, out)

    stats.config = cfg
    return stats


#: the TPU's W-streaming twin computes the same function: the same op here
make_tiled_cd_stats_kernel = make_cd_stats_kernel


def stats_buffer(n_visible, n_hidden, device):
    """An empty flat float32 buffer for ``[assoc | dvb_sum | dhb_sum |
    h_sum]``."""
    V, H = int(n_visible), int(n_hidden)
    return torch.empty(V * H + V + 2 * H, dtype=torch.float32, device=device)


def split_stats(flat, n_visible, n_hidden):
    """The four sums as views of the flat buffer."""
    V, H = int(n_visible), int(n_hidden)
    a = V * H
    return {'assoc': flat[:a].view(V, H), 'dvb_sum': flat[a:a + V],
            'dhb_sum': flat[a + V:a + V + H], 'h_sum': flat[a + V + H:]}


def _out_buffer(cfg, out, device):
    if out is None:
        return stats_buffer(cfg.n_visible, cfg.n_hidden, device)
    V, H = cfg.n_visible, cfg.n_hidden
    check_tensors([(out, 'out')], device, {'out': (V * H + V + 2 * H,)})
    return out


# ---------------------------------------------------------------------- #
# plain version                                                           #
# ---------------------------------------------------------------------- #
def cd_stats_reference(cfg, state, X, seed, it, shard, out=None):
    """The plain PyTorch version (see the module docstring)."""
    W, vb, hb = state['W'], state['vb'], state['hb']
    seed, it, shard = int(seed), int(it), int(shard)
    sigma = sigma_row(cfg, X.device)
    h0 = h_means_reference(cfg, X, W, hb)
    h_states = h_sample_reference(cfg, h0, seed, it, STREAM_H0, shard) \
        if cfg.sample_h_states else h0
    v_means, v_states, h_means = X, X, h0
    for s in range(cfg.k):
        v_means = v_means_reference(cfg, h_states, W, vb, sigma)
        v_states = v_sample_reference(cfg, v_means, sigma, seed, it,
                                      stream_v(s), shard) \
            if cfg.sample_v_states else v_means
        h_means = h_means_reference(cfg, v_states, W, hb)
        h_states = h_sample_reference(cfg, h_means, seed, it, stream_h(s),
                                      shard) \
            if cfg.sample_h_states else h_means
    stats = split_stats(_out_buffer(cfg, out, X.device), cfg.n_visible,
                        cfg.n_hidden)
    torch.sub(X.T @ h0, v_states.T @ h_means, out=stats['assoc'])
    torch.sum(X - v_states, dim=0, out=stats['dvb_sum'])
    torch.sum(h0 - h_means, dim=0, out=stats['dhb_sum'])
    torch.sum(h_means, dim=0, out=stats['h_sum'])
    return stats, {'X': X, 'v_means': v_means}


# ---------------------------------------------------------------------- #
# CUDA kernels                                                            #
# ---------------------------------------------------------------------- #
def _cd_stats_cuda(cfg, state, X, seed, it, shard, out):
    """Launch the kernels of ``csrc/cd_epoch.cu`` for one local batch."""
    V, H = cfg.n_visible, cfg.n_hidden
    dev = X.device
    if X.dim() != 2 or X.shape[1] != V or X.shape[0] < 1:
        raise ValueError('X_local must be (rows, {0}), got {1}'.format(
            V, tuple(X.shape)))
    W, vb, hb = state['W'], state['vb'], state['hb']
    check_tensors([(X, 'X_local'), (W, 'W'), (vb, 'vb'), (hb, 'hb')], dev,
                  {'W': (V, H), 'vb': (V,), 'hb': (H,)})
    B = int(X.shape[0])
    seed, it, shard = int(seed), int(it), int(shard)
    if not (0 <= seed < 2 ** 32 and 0 <= it < 2 ** 32
            and 0 <= shard < 2 ** 32 and B * max(V, H) < 2 ** 32):
        raise ValueError('seed, iteration, shard and draw indices must fit '
                         'in 32 bits')
    flat = _out_buffer(cfg, out, dev)
    lib, launches = library(), cd_stats.launches
    stream = torch.cuda.current_stream(dev).cuda_stream
    sigma = sigma_row(cfg, dev)

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    h0 = empty(B, H)
    h_samp = empty(B, H) if cfg.sample_h_states else None
    _launch_h_pass(lib, stream, cfg, X, W, hb, h0, h_samp, None, seed, it,
                   STREAM_H0, shard, launches)
    h_states = h_samp if cfg.sample_h_states else h0
    v_states, v_m, h_m = X, X, h0
    if cfg.k:
        v_means, h_means = empty(B, V), empty(B, H)
        v_samp = empty(B, V) if cfg.sample_v_states else None
    for s in range(cfg.k):
        _launch_v_pass(lib, stream, cfg, h_states, W, vb, sigma, v_means,
                       v_samp, seed, it, stream_v(s), shard, launches)
        v_m = v_means
        v_states = v_samp if cfg.sample_v_states else v_means
        _launch_h_pass(lib, stream, cfg, v_states, W, hb, h_means, h_samp,
                       None, seed, it, stream_h(s), shard, launches)
        h_m = h_means
        h_states = h_samp if cfg.sample_h_states else h_means

    a = V * H
    check_launch(lib.bm_cd_stats_sums(
        ptr(X), ptr(v_states), ptr(h0), ptr(h_m), B, V, H, ptr(flat, a),
        ptr(flat, a + V), ptr(flat, a + V + H), stream), 'cd_stats_sums')
    launches['cd_stats_sums'] += 1
    check_launch(lib.bm_cd_assoc_stats(
        ptr(X), ptr(h0), ptr(v_states), ptr(h_m), B, V, H, ptr(flat),
        stream), 'cd_assoc_stats')
    launches['cd_assoc_stats'] += 1
    return split_stats(flat, V, H), {'X': X, 'v_means': v_m}


def cd_stats(cfg, state, X, seed, it, shard, out=None):
    """One local batch's statistics: the CUDA kernels for a CUDA tensor, the
    plain version for a CPU tensor."""
    if X.device.type == 'cuda':
        return _cd_stats_cuda(cfg, state, X, seed, it, shard, out)
    if X.device.type == 'cpu':
        return cd_stats_reference(cfg, state, X, seed, it, shard, out)
    raise ValueError('cd_stats runs on CUDA (kernels) or the CPU (plain '
                     'version), not on {0}'.format(X.device))


cd_stats.launches = dict.fromkeys(KERNELS, 0)


def reset_launches():
    for name in KERNELS:
        cd_stats.launches[name] = 0
