"""The fit loop's validation metrics and free-energy gap of an RBM as
whole-set passes on the CD kernels.

The fit loop of ``rbm/base_rbm.py`` validates every few epochs: the msre of
a k-step chain and the PLL over the validation set, and the free-energy gap
between probe rows of the training and the validation set.  The generic
path walks the set batch by batch in torch ops; on the kernel path W does
not change meanwhile, so every batch is one slice of a single pass over the
whole set (the JAX package runs it as one ``lax.scan`` dispatch)::

    msre, pll = cd_val(cfg, state, X, batch_size, seed, msre=True, pll=True)
    fe_val, fe_train = cd_feg(cfg, state, X_val, X_train, batch_size, seed)

`cfg` is the epoch's ``CDEpochConfig`` (``cd_epoch_config``), `state` the
dict {W, vb, hb, ...}, `X` a contiguous (N, n_visible) float32 set, as
staged (Gaussian rows divided by sigma).  Both return a (2,) tensor on X's
device, one readback.

Semantics are the generic path's.  The set is cut into batch segments, rows
[s B, s B + B) and the remainder as a segment of its own; each metric is the
mean over the segments of the segment's value: the msre of the chain's
last v_means (zeros at k = 0), the PLL ``V log_sigmoid(fe(x~) - fe(x))``
with batch-mean free energies and one flipped unit a row
(``pll_from_flip``), and the batch-mean free energy (the FEG's, whose
multinomial lgamma constant cancels in the gap and is left out, as the
kernels' PLL leaves it).  The chain runs only for the msre and skips the
last step's hidden pass and visible draw, which the metrics do not read.

Draws: the Philox streams of ``ops/philox.py`` under key (seed, it), the
row's place in its chunk as the element index (for a set in one chunk, its
place in the set): ``STREAM_H0``, ``stream_v(s)``, ``stream_h(s)`` for the
chain, ``STREAM_PLL`` for the flips, and per segment ``s`` count vectors
of the multinomial free energies at elements ``s n ..`` on
``STREAM_PLL_HHAT`` (and ``STREAM_PLL_HHAT_FLIP`` for the flipped rows).
Validation takes it = the chunk's index; the FEG it = 2 x chunk + side
(0 validation, 1 training), so the two sides draw apart.  The generic path
draws from a ``torch.Generator``: other draws of the same law.

Chunks: whole batches at a time, as many as ``CHUNK_BYTES`` of buffers
hold (the MNIST sets take one chunk), so a large set allocates no more.

On a CUDA tensor each chunk is a few launches of ``csrc/cd_epoch.cu``,
counted in ``cd_epoch.launches``: ``cd_gemm_act`` (and
``cd_softmax_sample``) for the chain, ``cd_metrics`` for the free
energies' first launch (the softplus rows, or the count vectors, whose
u = W.hh is one more ``cd_gemm_act``), and ``cd_val_reduce``.  On a CPU
tensor the plain version (``cd_pass_reference``) draws the same numbers.
``cd_val.passes`` counts the passes run: 'val' one a validation, 'feg' one
a side of the gap.
"""

import numpy as np
import torch

from .cd_epoch import (ACT_PRE, _launch_gemm_act, _launch_h_pass,
                       _launch_v_pass, cd_epoch, check_launch, check_tensors,
                       free_energy_sum, h_means_reference, h_sample_reference,
                       library, pll_flip_index, pll_from_flip, ptr, sigma_row,
                       v_means_reference, v_sample_reference)
from .gemm import TILE_M, count_stages, launch_plan
from .philox import (STREAM_H0, STREAM_PLL_HHAT, STREAM_PLL_HHAT_FLIP,
                     multinomial_counts, stream_h, stream_v)

#: the most bytes of buffers a pass holds at once (a chunk's chain, free
#: energies and draws)
CHUNK_BYTES = 256 << 20


def chunk_rows(cfg, n_rows, batch_size, chain, fe, flip):
    """Rows of one chunk: whole batches whose buffers fit in CHUNK_BYTES
    (at least one batch), and whose draw indices fit in 32 bits."""
    V, H, B = cfg.n_visible, cfg.n_hidden, int(batch_size)
    multinomial = cfg.hidden == 'multinomial'
    per = 2 if flip else 1
    floats = 0.
    if chain:
        floats += V * (1 + cfg.sample_v_states) + \
            H * (1 + cfg.sample_h_states + multinomial)
    if fe:
        floats += per * (V + H) / B if multinomial else \
            per * -(-H // TILE_M)
    limit = CHUNK_BYTES / max(4. * floats, 1.)
    n = cfg.n_samples if multinomial else 0
    limit = min(limit, (2 ** 32 - 1) // max(V, H, n, 1))
    if B > limit:
        raise ValueError('a batch of {0} rows does not fit the pass\'s '
                         'buffers or 32-bit draw indices'.format(B))
    return min(int(limit) // B * B, -(-int(n_rows) // B) * B)


def _segment_counts(cfg, n_segments, per, seed, it, device):
    """The count vectors of the multinomial free energies, `per` a segment
    ((per x n_segments, H), segment-major), or None for Bernoulli hidden
    units."""
    if cfg.hidden != 'multinomial':
        return None
    m = np.float32(cfg.n_samples) / np.float32(cfg.n_hidden)
    means = torch.full((n_segments, cfg.n_hidden), float(m),
                       dtype=torch.float32, device=device)
    draws = [multinomial_counts(means, cfg.n_samples, seed, it, stream)
             for stream in (STREAM_PLL_HHAT, STREAM_PLL_HHAT_FLIP)[:per]]
    return torch.stack(draws, dim=1).reshape(per * n_segments, -1)


def _chain_reference(cfg, X, W, vb, hb, sigma, seed, it):
    """The chain's last v_means (zeros at k = 0) in torch ops."""
    if cfg.k == 0:
        return torch.zeros_like(X)
    h = h_means_reference(cfg, X, W, hb)
    h_states = h_sample_reference(cfg, h, seed, it, STREAM_H0) \
        if cfg.sample_h_states else h
    for s in range(cfg.k):
        v_means = v_means_reference(cfg, h_states, W, vb, sigma)
        if s == cfg.k - 1:
            return v_means
        v_states = v_sample_reference(cfg, v_means, sigma, seed, it,
                                      stream_v(s)) \
            if cfg.sample_v_states else v_means
        h = h_means_reference(cfg, v_states, W, hb)
        h_states = h_sample_reference(cfg, h, seed, it, stream_h(s)) \
            if cfg.sample_h_states else h


def cd_pass_reference(cfg, state, X, batch_size, seed, key0, step, msre, fe,
                      flip):
    """The plain version of a whole-set pass: (msre, pll, fe), the means
    over the batch segments, as a (3,) tensor (0 where not asked for);
    chunk c draws under key (seed, key0 + step c)."""
    W, vb, hb = state['W'], state['vb'], state['hb']
    N, V = X.shape
    B = int(batch_size)
    sigma = sigma_row(cfg, X.device)
    kw = dict(visible=cfg.visible, hidden=cfg.hidden, sigma=sigma)
    per = 2 if flip else 1
    rows_c = chunk_rows(cfg, N, B, msre and cfg.k > 0, fe, flip)
    per_segment = []
    for c, c0 in enumerate(range(0, N, rows_c)):
        Xc = X[c0:c0 + rows_c]
        R, it = Xc.shape[0], key0 + step * c
        vm = _chain_reference(cfg, Xc, W, vb, hb, sigma, seed, it) \
            if msre else None
        flips = pll_flip_index(seed, it, R, V, X.device) if flip else None
        hh = _segment_counts(cfg, -(-R // B), per, seed, it, X.device) \
            if fe else None
        for s, s0 in enumerate(range(0, R, B)):
            Xs = Xc[s0:s0 + B]
            b = Xs.shape[0]
            out = torch.zeros(3, dtype=X.dtype, device=X.device)
            if msre:
                out[0] = torch.mean(torch.square(Xs - vm[s0:s0 + B]))
            if fe:
                # the segment's count vectors: fe(x)'s, the flipped rows'
                h_hats = (None, None) if hh is None else \
                    (hh[per * s], hh[per * s + per - 1])
                out[2] = free_energy_sum(Xs, Xs @ W, vb, hb,
                                         h_hat=h_hats[0], **kw) / b
            if flip:
                out[1] = pll_from_flip(Xs, flips[s0:s0 + B], W, vb, hb,
                                       h_hats=h_hats, **kw)
            per_segment.append(out)
    return torch.stack(per_segment).mean(dim=0)


def _chain_cuda(lib, stream, cfg, X, W, vb, hb, sigma, seed, it, empty):
    """The chain on every row of the chunk `X` by the epoch's launch
    helpers; returns the last v_means (None at k = 0: zeros)."""
    if cfg.k == 0:
        return None
    R = X.shape[0]
    V, H = cfg.n_visible, cfg.n_hidden
    h_means = empty(R, H)
    h_samp = empty(R, H) if cfg.sample_h_states else None
    pre = empty(R, H) if cfg.hidden == 'multinomial' else None
    v_means = empty(R, V)
    v_samp = empty(R, V) if cfg.sample_v_states and cfg.k > 1 else None
    _launch_h_pass(lib, stream, cfg, X, W, hb, h_means, h_samp, pre, seed,
                   it, STREAM_H0)
    for s in range(cfg.k):
        h_states = h_samp if cfg.sample_h_states else h_means
        last = s == cfg.k - 1
        _launch_v_pass(lib, stream, cfg, h_states, W, vb, sigma, v_means,
                       None if last else v_samp, seed, it, stream_v(s))
        if last:
            break
        v_states = v_samp if cfg.sample_v_states else v_means
        _launch_h_pass(lib, stream, cfg, v_states, W, hb, h_means, h_samp,
                       pre, seed, it, stream_h(s))
    return v_means


def _cd_pass_cuda(cfg, state, X, batch_size, seed, key0, step, msre, fe,
                  flip, outs):
    """A whole-set pass by the kernels of ``csrc/cd_epoch.cu``; the last
    chunk's cd_val_reduce writes msre, pll and fe to those of the 0-d
    tensors `outs` that are not None."""
    N, V = X.shape
    H, B = cfg.n_hidden, int(batch_size)
    W, vb, hb = state['W'], state['vb'], state['hb']
    dev = X.device
    check_tensors([(X, 'X'), (W, 'W'), (vb, 'vb'), (hb, 'hb')], dev,
                  {'W': (V, H), 'vb': (V,), 'hb': (H,)})
    lib, stream = library(), torch.cuda.current_stream(dev).cuda_stream
    launches = cd_epoch.launches
    sigma = sigma_row(cfg, dev)
    multinomial = cfg.hidden == 'multinomial'
    per = 2 if flip else 1

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    rows_c = chunk_rows(cfg, N, B, msre and cfg.k > 0, fe, flip)
    row_out = empty(N, 3)
    # cd_val_reduce's last-block counter, and the zero bias of u = W.hh
    counter = torch.zeros(1, dtype=torch.int32, device=dev)
    no_bias = torch.zeros(V, dtype=torch.float32, device=dev) \
        if fe and multinomial else None
    for c, c0 in enumerate(range(0, N, rows_c)):
        Xc = X[c0:c0 + rows_c]
        R, it = int(Xc.shape[0]), key0 + step * c
        vm = _chain_cuda(lib, stream, cfg, Xc, W, vb, hb, sigma, seed, it,
                         empty) if msre else None
        fe_rows = u = None
        tiles = 0
        if fe and multinomial:
            hh = empty(per * -(-R // B), H)
            check_launch(lib.bm_cd_val_draw(
                hh.shape[0], per, H, cfg.n_samples, seed, it, ptr(hh),
                stream), 'cd_metrics')
            launches['cd_metrics'] += 1
            # u = W.hh of every count vector: the visible pass's product
            u = empty(hh.shape[0], V)
            _launch_gemm_act(lib, stream, hh, W, True, no_bias, None, 1.,
                             ACT_PRE, u, None, seed, it, 0)
        elif fe:
            plan, ws, counters = launch_plan(R, H, V, dev, stream)
            tiles = plan.model_tiles
            fe_rows = empty(per * R * tiles)
            check_launch(lib.bm_cd_val_fe(
                ptr(Xc), ptr(W), ptr(hb), R, V, H, int(flip), seed, it,
                plan.n_tile, plan.splits, ptr(ws), ptr(counters),
                ptr(fe_rows), stream), 'cd_metrics')
            launches['cd_metrics'] += 1
            count_stages('fe_rows', plan.k_tiles, plan.splits)
        check_launch(lib.bm_cd_val_reduce(
            ptr(Xc), ptr(vm), ptr(vb), ptr(sigma), ptr(fe_rows), tiles,
            ptr(u), per, R, V, B, int(msre), int(fe), int(flip), seed, it,
            c0, N, int(c0 + R == N), ptr(row_out), ptr(counter),
            *(ptr(o) for o in outs), stream), 'cd_val_reduce')
        launches['cd_val_reduce'] += 1


def _cd_pass(cfg, state, X, batch_size, seed, key0, step, msre, fe, flip,
             outs):
    """Run one pass into `outs`, the 0-d tensors on X's device for the msre,
    the pll and the free energy (None: not written): the kernels for a CUDA
    tensor, the plain version for a CPU one."""
    if X.dim() != 2 or X.shape[1] != cfg.n_visible or X.shape[0] < 1 \
            or int(batch_size) < 1:
        raise ValueError('X must be (rows >= 1, {0}) and the batch size '
                         '>= 1, got {1} and {2}'.format(
                             cfg.n_visible, tuple(X.shape), batch_size))
    if not 0 <= int(seed) < 2 ** 32:
        raise ValueError('seed must fit in 32 bits')
    if X.device.type == 'cuda':
        _cd_pass_cuda(cfg, state, X, batch_size, int(seed), key0, step,
                      msre, fe, flip, outs)
    elif X.device.type == 'cpu':
        got = cd_pass_reference(cfg, state, X, batch_size, int(seed), key0,
                                step, msre, fe, flip)
        for o, v in zip(outs, got):
            if o is not None:
                o.copy_(v)
    else:
        raise ValueError('the whole-set passes run on CUDA (kernels) or the '
                         'CPU (plain version), not on {0}'.format(X.device))


def cd_val(cfg, state, X, batch_size, seed, msre=True, pll=True):
    """(msre, pll) of the set X as a (2,) tensor (0 where not asked for):
    one pass, the chain only for the msre, the free energies only for the
    PLL."""
    out = torch.empty(2, dtype=torch.float32, device=X.device)
    _cd_pass(cfg, state, X, batch_size, seed, 0, 1, bool(msre), bool(pll),
             bool(pll), (out[0], out[1], None))
    cd_val.passes['val'] += 1
    return out


def cd_feg(cfg, state, X_val, X_train, batch_size, seed):
    """(fe_val, fe_train): the mean over batch segments of the batch-mean
    free energy of each side's probe rows, as a (2,) tensor."""
    out = torch.empty(2, dtype=torch.float32, device=X_val.device)
    for side, X in enumerate((X_val, X_train)):
        _cd_pass(cfg, state, X, batch_size, seed, side, 2, False, True,
                 False, (None, None, out[side]))
        cd_val.passes['feg'] += 1
    return out


cd_val.passes = {'val': 0, 'feg': 0}
