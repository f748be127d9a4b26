"""Inputs made from the seed: sub-seeds, data rows and weights.

Everything is drawn on the device in a few large calls by a
``torch.Generator`` seeded from ``--seed``; the same seed gives the same
inputs.  Data leaves the device as numpy arrays, as users hand them to
``fit``.
"""

import numpy as np
import torch


def sub_seed(seed, tag):
    """A 31-bit seed for the part `tag` (a small int) of a run of seed
    `seed` (any non-negative int, 64-bit and more included)."""
    words = [int(seed) >> s & 0xFFFFFFFF for s in (0, 32, 64)]
    ss = np.random.SeedSequence(words + [int(tag)])
    return int(ss.generate_state(1, np.uint32)[0]) & 0x7FFFFFFF


def generator(seed, device):
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g


def mnist_like(n_rows, spec, seed, device):
    """(n_rows, side^2) float32 rows in [0, 1] with MNIST's shape: pixel j
    is inked with probability ``ink exp(-r_j^2 / (2 (side / 4)^2))`` (r_j
    its distance from the centre), an inked pixel is 1 with probability
    ``full`` and uniform in (0, 1) otherwise.  Every row differs."""
    side, ink, full = int(spec['side']), float(spec['ink']), \
        float(spec['full'])
    g = generator(seed, device)
    c = (side - 1) / 2.
    i = torch.arange(side, dtype=torch.float32, device=device) - c
    r2 = (i[:, None] ** 2 + i[None, :] ** 2).reshape(-1)
    p = ink * torch.exp(-r2 / (2. * (side / 4.) ** 2))
    u = torch.rand((n_rows, side * side), generator=g, device=device)
    w = torch.rand((n_rows, side * side), generator=g, device=device)
    value = torch.clamp(w / (1. - full), max=1.)
    return torch.where(u < p, value, torch.zeros_like(value))


DATA = {'mnist_like': mnist_like}


def make_rows(n_rows, spec, seed, device):
    """Rows of the configuration's ``data`` spec, on the device."""
    return DATA[spec['kind']](n_rows, spec, seed, device)


def gaussian(shape, std, seed, device):
    """N(0, std^2) float32 weights on the device."""
    return torch.randn(shape, generator=generator(seed, device),
                       device=device) * float(std)
