"""Dtype and seed mixins (reference base/mixin.py:7-35 equivalents).

``DtypeMixin`` maps the user-facing ``dtype`` string to torch/np dtypes
(float64 is native in torch, so no global switch is needed).

``SeedMixin`` owns the checkpointable host RNG from which per-call op seeds
are drawn; a seed becomes a ``torch.Generator`` on the model's device.
"""

import numpy as np
import torch

from ..utils.rng import RNG


class BaseMixin(object):
    def __init__(self, *args, **kwargs):
        if args or kwargs:
            raise AttributeError('Invalid parameters: {0}, {1}'.format(args, kwargs))
        super(BaseMixin, self).__init__()


class DtypeMixin(BaseMixin):
    def __init__(self, dtype='float32', *args, **kwargs):
        super(DtypeMixin, self).__init__(*args, **kwargs)
        self.dtype = dtype

    @property
    def _torch_dtype(self):
        return getattr(torch, self.dtype)

    @property
    def _np_dtype(self):
        return getattr(np, self.dtype)


def make_generator(seed, device='cpu'):
    """A ``torch.Generator`` on `device` seeded with `seed`."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g


class SeedMixin(BaseMixin):
    def __init__(self, random_seed=None, *args, **kwargs):
        super(SeedMixin, self).__init__(*args, **kwargs)
        self.random_seed = random_seed
        self._rng = RNG(seed=self.random_seed)

    def make_random_seed(self):
        """Draw a fresh op seed, advancing the persisted RNG state."""
        return int(self._rng.randint(2 ** 31 - 1))

    def make_generator(self, device='cpu'):
        """Draw a fresh op seed from the persisted host RNG; return it with
        a ``torch.Generator`` on `device` seeded from it."""
        seed = self.make_random_seed()
        return seed, make_generator(seed, device)
