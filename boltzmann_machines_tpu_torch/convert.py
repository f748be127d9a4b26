"""Model state as a torch module, and conversion to and from the JAX
package's checkpoint arrays.

The JAX package keeps an RBM's state as a dict of device arrays and saves
it in ``model.npz`` under the keys of ``STATE_ARRAY_KEYS``; this package
keeps the same seven tensors as registered buffers of an ``RBMState``
module, so ``.to(device)`` and ``state_dict()`` work, and saves them under
the same keys.  A DBM's state (``DBMState``) is the JAX package's DBM
pytree -- per-layer weights, accumulators, sparsity EMAs and the persistent
chains -- under the npz keys of ``DBM_ARRAY_KEYS``.  A checkpoint directory
written by either package therefore loads in the other.
"""

import json
import os

import numpy as np
import torch
from torch import nn

from .base.torch_model import resolve_device
from .ops.cd_epoch import STATE_KEYS
from .ops.dbm_ops import LAYER_KEYS as DBM_LAYER_KEYS
from .ops.dbm_ops import STATE_KEYS as DBM_STATE_KEYS

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


def state_from_jax_arrays(arrays, device=None, dtype=torch.float32):
    """``RBMState`` on `device` (default: the CUDA device; raises where
    there is none) from the JAX package's ``_get_state_arrays()`` dict (or
    a loaded ``model.npz``)."""
    device = resolve_device(device)
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


#: npz key of each DBM state tensor, ``{0}`` standing for the layer
#: (boltzmann_machines_tpu/dbm.py:273-307)
DBM_ARRAY_KEYS = {
    'vb': 'weights/vb', 'dvb': 'grads_accumulators/dvb',
    'v': 'negative_particles/v',
    'W': 'weights/W_{0}', 'hb': 'weights/hb_{0}',
    'dW': 'grads_accumulators/dW_{0}', 'dhb': 'grads_accumulators/dhb_{0}',
    'q_means': 'hidden_means_accumulators/q_means_{0}',
    'mu_means': 'hidden_means_accumulators/mu_means_{0}',
    'H': 'negative_particles/H_{0}',
}


class DBMState(nn.Module):
    """A DBM's state as buffers (``W_0``, ``hb_0``, ... per layer);
    ``as_dict`` gives the JAX package's pytree with per-layer tuples."""

    def __init__(self, tensors):
        super(DBMState, self).__init__()
        self.n_layers = len(tensors['W'])
        for key in DBM_STATE_KEYS:
            if key in DBM_LAYER_KEYS:
                for i, t in enumerate(tensors[key]):
                    self.register_buffer('{0}_{1}'.format(key, i), t)
            else:
                self.register_buffer(key, tensors[key])

    def as_dict(self):
        return {key: (tuple(getattr(self, '{0}_{1}'.format(key, i))
                            for i in range(self.n_layers))
                      if key in DBM_LAYER_KEYS else getattr(self, key))
                for key in DBM_STATE_KEYS}

    def update(self, tensors):
        """Replace the buffers with the tensors of a new state."""
        for key in DBM_STATE_KEYS:
            if key in DBM_LAYER_KEYS:
                for i, t in enumerate(tensors[key]):
                    setattr(self, '{0}_{1}'.format(key, i), t)
            else:
                setattr(self, key, tensors[key])


def dbm_state_from_jax_arrays(arrays, device=None, dtype=torch.float32):
    """``DBMState`` on `device` (default: the CUDA device; raises where
    there is none) from the JAX DBM's ``_get_state_arrays()`` dict (or a
    loaded ``model.npz``); the layer count is read from the keys."""
    device = resolve_device(device)
    n_layers = sum(1 for k in arrays if k.startswith('weights/W_'))

    def tensor(npz_key):
        return torch.tensor(np.asarray(arrays[npz_key]), dtype=dtype,
                            device=device)

    return DBMState({
        key: (tuple(tensor(npz_key.format(i)) for i in range(n_layers))
              if key in DBM_LAYER_KEYS else tensor(npz_key))
        for key, npz_key in DBM_ARRAY_KEYS.items()})


def dbm_state_to_numpy(state):
    """The JAX DBM's state-array dict (numpy, npz keys) of a ``DBMState``
    or a DBM state pytree of tensors."""
    if isinstance(state, DBMState):
        state = state.as_dict()
    out = {}
    for key, npz_key in DBM_ARRAY_KEYS.items():
        if key in DBM_LAYER_KEYS:
            for i, t in enumerate(state[key]):
                out[npz_key.format(i)] = t.detach().cpu().numpy()
        else:
            out[npz_key] = state[key].detach().cpu().numpy()
    return out


def load_model(model_path, device=None):
    """Load a checkpoint directory written by either package, choosing the
    class from its ``params.json``, onto `device` (default: the CUDA device;
    raises where there is none)."""
    from .rbm import BernoulliRBM, GaussianRBM, MultinomialRBM
    from .dbm import DBM
    from .base.torch_model import TorchModel
    classes = {c.__name__: c for c in (BernoulliRBM, GaussianRBM,
                                       MultinomialRBM, DBM)}
    paths = TorchModel.compute_working_paths(model_path)
    with open(paths['params_filepath']) as f:
        class_name = json.load(f)['__class_name__']
    if class_name not in classes:
        raise NotImplementedError(
            '{0} checkpoints ({1}) are not ported yet (ROADMAP.md Queue A)'
            .format(class_name, os.path.abspath(paths['model_dirpath'])))
    return classes[class_name].load_model(model_path, device=device)
