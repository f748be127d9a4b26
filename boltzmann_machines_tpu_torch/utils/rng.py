"""Checkpointable host-side RNG.

A thin ``np.random.RandomState`` subclass whose state round-trips through
JSON.  It plays the same role as the reference's python RNG
(reference utils/rng.py:4-62): every device computation draws a fresh
*op seed* from this generator, and because the generator state is persisted
with the model, resumed training is trajectory-identical.

On the device side the op seed seeds a ``torch.Generator`` (the generic
path) or keys the counter-based Philox stream of the CUDA kernels
(``ops/philox.py``), replacing TF1 graph-level seeds.
"""

import numpy as np


class RNG(np.random.RandomState):
    """JSON-serializable random number generator.

    Examples
    --------
    >>> rng = RNG(1337)
    >>> state = rng.get_state()
    >>> a, b = rng.rand(), rng.rand()
    >>> _ = rng.reseed()
    >>> (rng.rand(), rng.rand()) == (a, b)
    True
    >>> _ = rng.set_state(state)
    >>> rng.rand() == a
    True
    >>> import json
    >>> state2 = json.loads(json.dumps(state))
    >>> rng.set_state(state2).rand() == a
    True
    """

    def __init__(self, seed=None):
        self._seed = seed
        super(RNG, self).__init__(self._seed)

    def reseed(self):
        if self._seed is not None:
            self.seed(self._seed)
        return self

    def get_state(self, legacy=True):
        """Get JSON-serializable inner state."""
        state = super(RNG, self).get_state(legacy=True)
        state = list(state)
        state[1] = state[1].tolist()
        return state

    def set_state(self, state):
        """Complementary method to `get_state`."""
        state = list(state)
        state[1] = np.asarray(state[1], dtype=np.uint32)
        super(RNG, self).set_state(tuple(state))
        return self
