"""Model state as a torch module, and conversion to and from the JAX
package's checkpoint arrays.

The JAX package keeps an RBM's state as a dict of device arrays and saves
it in ``model.npz`` under the keys of ``STATE_ARRAY_KEYS``; this package
keeps the same seven tensors as registered buffers of an ``RBMState``
module, so ``.to(device)`` and ``state_dict()`` work, and saves them under
the same keys.  A checkpoint directory written by either package therefore
loads in the other.
"""

import json
import os

import numpy as np
import torch
from torch import nn

from .ops.cd_epoch import STATE_KEYS

#: npz key of each state tensor (boltzmann_machines_tpu/rbm/base_rbm.py:232)
STATE_ARRAY_KEYS = {
    'W': 'weights/W', 'vb': 'weights/vb', 'hb': 'weights/hb',
    'dW': 'grads_accumulators/dW', 'dvb': 'grads_accumulators/dvb',
    'dhb': 'grads_accumulators/dhb',
    'q_means': 'hidden_activations_means/q_means',
}


class RBMState(nn.Module):
    """An RBM's state: weights, momentum accumulators and the sparsity EMA,
    as buffers (CD is not the gradient of a loss, so nothing here needs
    autograd)."""

    def __init__(self, tensors):
        super(RBMState, self).__init__()
        for key in STATE_KEYS:
            self.register_buffer(key, tensors[key])

    def as_dict(self):
        return {key: getattr(self, key) for key in STATE_KEYS}

    def update(self, tensors):
        """Replace the buffers with the tensors of a new state."""
        for key in STATE_KEYS:
            setattr(self, key, tensors[key])


def state_from_jax_arrays(arrays, device='cpu', dtype=torch.float32):
    """``RBMState`` on `device` from the JAX package's
    ``_get_state_arrays()`` dict (or a loaded ``model.npz``)."""
    return RBMState({key: torch.tensor(np.asarray(arrays[npz_key]),
                                       dtype=dtype, device=device)
                     for key, npz_key in STATE_ARRAY_KEYS.items()})


def state_to_numpy(state):
    """The JAX package's state-array dict (numpy, npz keys) of an
    ``RBMState`` or a state dict of tensors."""
    if isinstance(state, RBMState):
        state = state.as_dict()
    return {npz_key: state[key].detach().cpu().numpy()
            for key, npz_key in STATE_ARRAY_KEYS.items()}


def load_model(model_path, device='cpu'):
    """Load a checkpoint directory written by either package, choosing the
    class from its ``params.json``."""
    from .rbm import BernoulliRBM
    from .base.torch_model import TorchModel
    classes = {c.__name__: c for c in (BernoulliRBM,)}
    paths = TorchModel.compute_working_paths(model_path)
    with open(paths['params_filepath']) as f:
        class_name = json.load(f)['__class_name__']
    if class_name not in classes:
        raise NotImplementedError(
            '{0} checkpoints ({1}) are not ported yet (ROADMAP.md Queue A)'
            .format(class_name, os.path.abspath(paths['model_dirpath'])))
    return classes[class_name].load_model(model_path, device=device)
