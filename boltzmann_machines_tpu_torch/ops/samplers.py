"""Standalone samplers and the free-energy probe.

Ports of four TPU kernels of boltzmann_machines_tpu/ops/pallas_ops.py
over the device functions and kernels of the CD epoch (``csrc/cd_epoch.cu``),
one launch each but the probe's two:

* ``bernoulli_sample(seed, probs)`` -- Bernoulli states, the threshold
  draw of the epoch kernels' Bernoulli epilogue (``bernoulli_sample``, :74;
  ``pallas_call`` at :80);
* ``normal_sample(seed, shape)`` -- standard normals by Box-Muller
  (``normal_sample``, :95; ``pallas_call`` at :97);
* ``multinomial_sample(seed, means, n_samples)`` -- exact per-row
  Multinomial(n, means / n) counts (``multinomial_sample``, :106;
  ``pallas_call`` at :115);
* ``make_free_energy_probe(V, H, B, visible, hidden, n_samples)`` -- the
  batch-mean free energy the epoch's PLL uses, with the drawn count vector
  of multinomial hidden units (``make_free_energy_probe``, :208;
  ``pallas_call`` at :241): the metrics' two launches (``cd_metrics``),
  X.W on the tensor-core tile with a softplus-row epilogue or the count
  vector's draw, then the pass over W.

Each has a plain PyTorch version (``*_reference``) that draws the same
Philox numbers (key (seed, 0), or the two words of a two-word seed for
``bernoulli_sample``; ``ops/philox.py``), and a launch count on its wrapper
(``<wrapper>.launches``).  A CPU tensor (or ``device='cpu'``)
runs the plain version, a CUDA one launches the kernel or raises.
"""

import math

import numpy as np
import torch

from .cd_epoch import (check_flavour, check_launch, check_tensors,
                       free_energy_sum, library, metrics_workspace, ptr,
                       sigma_tensor, uniform_h_hat)
from .gemm import launch_plan
from .philox import (STREAM_PLL_HHAT, multinomial_counts, normal,
                     philox_uniform)


_NOT_32_BITS = 'seed and draw indices must fit in 32 bits'


def _check_seed(seed, n_draws):
    if not (0 <= int(seed) < 2 ** 32 and 0 <= int(n_draws) < 2 ** 32):
        raise ValueError(_NOT_32_BITS)


# the devices named so far: a name always names the same device, and
# torch.device() costs a microsecond of host a call (--sampler-readings)
_DEVICES = {}


def _device_of(device):
    known = _DEVICES.get(device)
    if known is not None:
        return known
    parsed = torch.device(device)
    if parsed.type not in ('cpu', 'cuda'):
        raise ValueError('runs on CUDA (kernel) or the CPU (plain version), '
                         'not on {0}'.format(parsed))
    _DEVICES[device] = parsed
    return parsed


def _stream(device):
    """The handle of the current CUDA stream of `device` (a device or its
    index), as the kernels take it: torch.accelerator's stream costs a
    third to a half of torch.cuda.current_stream's host time
    (--sampler-readings)."""
    return torch.accelerator.current_stream(device).native_handle


# ---------------------------------------------------------------------- #
# bernoulli_sample                                                        #
# ---------------------------------------------------------------------- #
def key_words(seed):
    """The Philox key (w0, w1) of `seed`: an int gives (seed, 0), two
    uint32 words (a sequence, array or tensor of 2) give (w0, w1) -- the
    TPU's ``_seed_words`` (pallas_ops.py:57-65)."""
    if type(seed) is int:  # the common case, without numpy
        words = (seed, 0)
    else:
        if isinstance(seed, torch.Tensor):
            seed = seed.tolist()
        a = np.asarray(seed)
        if a.ndim == 0:
            words = (int(a), 0)
        elif a.size == 2:
            words = tuple(int(w) for w in a.reshape(-1))
        else:
            raise ValueError('seed must be an int or two uint32 words, got '
                             'shape {0}'.format(a.shape))
    if not (0 <= words[0] < 2 ** 32 and 0 <= words[1] < 2 ** 32):
        raise ValueError('seed words must fit in 32 bits')
    return words


def bernoulli_sample_reference(seed, probs):
    w0, w1 = key_words(seed)
    u = philox_uniform(w0, w1, 0, probs.shape, probs.device)
    return (u.to(probs.dtype) < probs).to(probs.dtype)


def bernoulli_sample(seed, probs):
    """float32 states of the float32 `probs` (any shape): element ``i``
    (row-major) is 1 where the Philox uniform of counter (i, 0) under the
    key of `seed` (``key_words``) is below ``probs[i]``, else 0."""
    w0, w1 = key_words(seed)
    count = probs.numel()
    if count >= 2 ** 32:
        raise ValueError(_NOT_32_BITS)
    if not probs.is_cuda:
        _device_of(probs.device)
        return bernoulli_sample_reference(seed, probs)
    if probs.dtype != torch.float32 or not probs.is_contiguous():
        check_tensors([(probs, 'probs')], probs.device, {})
    out = torch.empty_like(probs)
    check_launch(library().bm_bernoulli_sample(
        probs.data_ptr(), out.data_ptr(), count, w0, w1,
        _stream(probs.get_device())), 'bernoulli_sample')
    bernoulli_sample.launches['bernoulli_sample'] += 1
    return out


bernoulli_sample.launches = {'bernoulli_sample': 0}


# ---------------------------------------------------------------------- #
# normal_sample                                                           #
# ---------------------------------------------------------------------- #
def normal_sample_reference(seed, shape, device='cpu'):
    return normal(int(seed), 0, 0, tuple(shape), device)


def normal_sample(seed, shape, device='cuda'):
    """float32 standard normals of `shape`, element ``i`` (row-major) from
    Philox counter (i, 0) under key (seed, 0)."""
    device = _device_of(device)
    shape = tuple(map(int, shape))
    count, seed = math.prod(shape), int(seed)
    if not (0 <= seed < 2 ** 32 and 0 <= count < 2 ** 32):
        raise ValueError(_NOT_32_BITS)
    if device.type == 'cpu':
        return normal_sample_reference(seed, shape, device)
    # the sizes as separate ints: torch parses them faster than one tuple
    out = (torch.empty(*shape, dtype=torch.float32, device=device) if shape
           else torch.empty((), dtype=torch.float32, device=device))
    check_launch(library().bm_normal_sample(
        out.data_ptr(), count, seed, _stream(out.get_device())),
        'normal_sample')
    normal_sample.launches['normal_sample'] += 1
    return out


normal_sample.launches = {'normal_sample': 0}


# ---------------------------------------------------------------------- #
# multinomial_sample                                                      #
# ---------------------------------------------------------------------- #
def multinomial_sample_reference(seed, means, n_samples):
    return multinomial_counts(means, int(n_samples), int(seed), 0, 0)


def multinomial_sample(seed, means, n_samples):
    """Multinomial(n_samples, means / n_samples) counts per row of the
    (B, H) float32 expected counts `means` (rows summing to ~n_samples);
    draw ``j`` of row ``b`` from Philox counter (b * n + j, 0) under key
    (seed, 0)."""
    if means.dim() != 2 or means.shape[1] < 1:
        raise ValueError('means must be (rows, n_hidden), got {0}'.format(
            tuple(means.shape)))
    n = int(n_samples)
    if n < 1:
        raise ValueError('n_samples must be >= 1')
    _check_seed(seed, means.shape[0] * n)
    device = _device_of(means.device)
    if device.type == 'cpu':
        return multinomial_sample_reference(seed, means, n)
    check_tensors([(means, 'means')], device, {})
    B, H = means.shape
    out = torch.empty((B, H), dtype=torch.float32, device=device)
    check_launch(library().bm_cd_softmax_sample(
        ptr(means), 0, B, H, n, None, ptr(out), int(seed), 0, 0,
        _stream(device)), 'multinomial_sample')
    multinomial_sample.launches['multinomial_sample'] += 1
    return out


multinomial_sample.launches = {'multinomial_sample': 0}


# ---------------------------------------------------------------------- #
# make_free_energy_probe                                                  #
# ---------------------------------------------------------------------- #
def make_free_energy_probe(n_visible, n_hidden, batch_size, visible,
                           hidden, n_samples=None):
    """``probe(X, W, vb, hb, sigma, seed) -> (fe, h_hat)``: the batch-mean
    free energy of the (B, V) float32 `X` as the epoch kernels' PLL
    computes it (Gaussian inputs already divided by `sigma`, vb raw; no
    multinomial lgamma constant), and the (H,) count vector drawn for
    multinomial hidden units (zeros for Bernoulli ones) under key
    (seed, 0) on ``STREAM_PLL_HHAT``."""
    V, H, B = int(n_visible), int(n_hidden), int(batch_size)
    check_flavour(visible, hidden, n_samples)
    n = int(n_samples) if hidden == 'multinomial' else 0

    def reference(X, W, vb, hb, sigma, seed):
        sig = sigma_tensor(sigma, V, X.device) \
            if visible == 'gaussian' else None
        h_hat = (uniform_h_hat(n, H, int(seed), 0, STREAM_PLL_HHAT,
                               X.device)[0]
                 if n else torch.zeros(H, dtype=X.dtype, device=X.device))
        fe = free_energy_sum(X, X @ W, vb, hb, visible, hidden, sig,
                             h_hat) / B
        return fe, h_hat

    def probe(X, W, vb, hb, sigma, seed):
        _check_seed(seed, n)
        device = _device_of(X.device)
        if device.type == 'cpu':
            return reference(X, W, vb, hb, sigma, seed)
        sig = sigma_tensor(sigma, V, device) \
            if visible == 'gaussian' else None
        check_tensors([(X, 'X'), (W, 'W'), (vb, 'vb'), (hb, 'hb')], device,
                      {'X': (B, V), 'W': (V, H), 'vb': (V,), 'hb': (H,)})
        fe = torch.empty((), dtype=torch.float32, device=device)
        h_hat = torch.empty(H, dtype=torch.float32, device=device)
        launch_probe(X, W, vb, hb, sig, n, int(seed),
                     metrics_workspace(V, H, B, device), fe, h_hat,
                     _stream(device))
        make_free_energy_probe.launches['fe_probe'] += 2
        return fe, h_hat

    probe.reference = reference
    return probe


make_free_energy_probe.launches = {'fe_probe': 0}


def launch_probe(X, W, vb, hb, sigma, n, seed, ws, fe, h_hat, stream):
    """``bm_fe_probe`` on the CUDA stream `stream` (the handle): the probe's
    two launches, writing `fe` and `h_hat`; `ws` is
    ``ops/cd_epoch.metrics_workspace``'s scratch, and the product of
    Bernoulli hidden units takes the tile's plan (``ops/gemm.py``) with
    that stream's split-K workspace."""
    B, V = X.shape
    H = W.shape[1]
    n_tile, splits, tws, counters = 0, 0, None, None
    if not n:
        plan, tws, counters = launch_plan(B, H, V, X.device, stream)
        n_tile, splits = plan.n_tile, plan.splits
    check_launch(library().bm_fe_probe(
        ptr(X), ptr(W), ptr(vb), ptr(hb), ptr(sigma), B, V, H, n, seed,
        ws['w_rows'], n_tile, splits, ptr(tws), ptr(counters),
        ptr(ws['rows']), ptr(ws['partials']), ptr(ws['counter']), ptr(fe),
        ptr(h_hat), stream), 'fe_probe')


def reset_launches():
    for fn in (bernoulli_sample, normal_sample, multinomial_sample,
               make_free_energy_probe):
        for name in fn.launches:
            fn.launches[name] = 0
