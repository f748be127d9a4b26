"""Energy-based model contract (reference ebm.py:4-17 analog)."""

from .base import TorchModel


class EnergyBasedModel(TorchModel):
    """A model with a free-energy function F(v); p(v) = exp(-F(v)) / Z."""

    def __init__(self, *args, **kwargs):
        super(EnergyBasedModel, self).__init__(*args, **kwargs)

    def _free_energy(self, state, v, generator=None):
        """Batch-mean free energy of visible configurations `v` (plain
        tensor code).

        `generator` feeds models whose free energy is a Monte-Carlo
        estimate; deterministic energies ignore it."""
        raise NotImplementedError('`_free_energy` is not implemented')
