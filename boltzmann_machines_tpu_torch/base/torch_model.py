"""Model runtime: working paths, checkpoints, fit lifecycle.

The counterpart of the JAX package's ``JAXModel``.  A checkpoint directory
holds the same three files, in the same formats, so a checkpoint written by
either package loads in the other:

* ``params.json``       -- all hyperparameters + trailing-underscore attrs
                           + ``__class_name__`` (class-checked on load);
* ``random_state.json`` -- host RNG state (trajectory-identical resume);
* ``model.npz``         -- the flattened model state (weights, momentum
                           accumulators, EMA means).

The model's device is private (``_device``) and never enters
``params.json``.  By default it is the CUDA device: the port runs on the
card, and the CPU is asked for by name (``device='cpu'``); a model built
without a device where there is no CUDA device raises.  Checkpoints and
metrics are written synchronously at the end of each epoch, by one process
only when several train one model (``_writes_files``).
"""

import os
import json

import numpy as np
import torch

from .base import is_param_name
from .base_model import BaseModel
from .mixin import DtypeMixin
from ..utils.profiler import annotate


def default_device():
    """The device of a model, state or checkpoint given none: the card."""
    return 'cuda'


def resolve_device(device=None):
    """`device` as a ``torch.device``; None means ``default_device()``,
    which raises where there is no CUDA device rather than running on the
    CPU unasked."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: the port runs on the card "
                               "unless asked otherwise -- pass "
                               "device='cpu' to run on the CPU")
        device = default_device()
    return torch.device(device)


def device_histogram(x, n_buckets=64):
    """Linear-bucket histogram of a tensor, reduced on its device (the JAX
    package's ``base/jax_model.device_histogram``).

    Returns a small dict of tensors on that device -- ``counts`` (int32,
    `n_buckets`), ``min``, ``max``, ``sum``, ``sum_sq`` and
    ``n_nonfinite`` -- for ``SummaryWriter.add_device_histogram`` once
    `to_host` has fetched it: the whole tensor never leaves the device.
    Non-finite entries are left out of the buckets, min/max and moments
    and counted apart (an all-bad tensor gives min = max = 0); the bucket
    of x is ``clip(int((x - min) / span * n), 0, n - 1)`` with ``span =
    max(max - min, 1e-30)``, in float32 in that order, as the JAX package
    computes it."""
    x = x.reshape(-1).to(torch.float32)
    finite = torch.isfinite(x)
    n_bad = torch.sum(~finite).to(torch.int32)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    xf = torch.where(finite, x, zero)
    big = torch.full((), 3.4e38, dtype=torch.float32, device=x.device)
    vmin = torch.min(torch.where(finite, x, big))
    vmax = torch.max(torch.where(finite, x, -big))
    vmin = torch.where(vmin > vmax, zero, vmin)
    vmax = torch.where(vmax < vmin, zero, vmax)
    span = torch.clamp(vmax - vmin, min=1e-30)
    idx = torch.clamp(((xf - vmin) / span * n_buckets).to(torch.int32),
                      0, n_buckets - 1)
    counts = torch.zeros((n_buckets,), dtype=torch.int32,
                         device=x.device).index_add_(
                             0, idx, finite.to(torch.int32))
    return {'counts': counts, 'min': vmin, 'max': vmax,
            'sum': torch.sum(xf), 'sum_sq': torch.sum(xf * xf),
            'n_nonfinite': n_bad}


def to_host(tree):
    """Numpy copies of the tensors of a dict / list / tuple tree."""
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_host(v) for v in tree)
    return tree.detach().cpu().numpy() if torch.is_tensor(tree) else tree


class TorchModel(BaseModel, DtypeMixin):
    def __init__(self, model_path='torch_model/', paths=None,
                 json_params=None, device=None, *args, **kwargs):
        super(TorchModel, self).__init__(*args, **kwargs)
        self._device = resolve_device(device)
        self._model_dirpath = None
        self._model_filepath = None
        self._params_filepath = None
        self._random_state_filepath = None
        self._train_summary_dirpath = None
        self._val_summary_dirpath = None
        self.update_working_paths(model_path=model_path, paths=paths)

        self.json_params = json_params or {}
        self.json_params.setdefault('sort_keys', True)
        self.json_params.setdefault('indent', 4)
        self.initialized_ = False

    @staticmethod
    def compute_working_paths(model_path):
        """Derive all artifact paths from `model_path` (dirpath ending with
        a slash, or a filepath whose basename names the checkpoint)."""
        head, tail = os.path.split(model_path)
        if not head:
            head = '.'
        if not head.endswith('/'):
            head += '/'
        if not tail:
            tail = 'model'

        paths = {}
        paths['model_dirpath'] = head
        paths['model_filepath'] = os.path.join(head, tail)
        paths['params_filepath'] = os.path.join(head, 'params.json')
        paths['random_state_filepath'] = os.path.join(head, 'random_state.json')
        paths['train_summary_dirpath'] = os.path.join(head, 'logs/train')
        paths['val_summary_dirpath'] = os.path.join(head, 'logs/val')
        return paths

    def update_working_paths(self, model_path=None, paths=None):
        paths = paths or {}
        if not paths:
            paths = TorchModel.compute_working_paths(model_path=model_path)
        for k, v in paths.items():
            setattr(self, '_{0}'.format(k), v)

    # ------------------------------------------------------------------ #
    # state-array protocol: subclasses expose their device state as a     #
    # flat dict of numpy arrays                                           #
    # ------------------------------------------------------------------ #
    def _get_state_arrays(self):
        raise NotImplementedError

    def _set_state_arrays(self, arrays):
        raise NotImplementedError

    def _init_state(self):
        """Build initial device state (fresh model)."""
        raise NotImplementedError

    def _ensure_state(self):
        raise NotImplementedError

    # ------------------------------------------------------------------ #
    # persistence                                                         #
    # ------------------------------------------------------------------ #
    def _checkpoint_payload(self):
        """JSON-able metadata: (params, host RNG state)."""
        params = self.get_params(deep=False)
        params = self._serialize(params)
        params['__class_name__'] = self.__class__.__name__
        rng_state = self._rng.get_state() \
            if self.random_seed is not None else None
        return params, rng_state

    def _write_checkpoint(self, params, rng_state, arrays):
        for dirpath in (self._train_summary_dirpath, self._val_summary_dirpath):
            if not os.path.exists(dirpath):
                os.makedirs(dirpath)

        # atomic writes: a crash mid-dump must not corrupt the checkpoint.
        # Commit ORDER matters: model.npz and random_state.json land first,
        # params.json is renamed LAST -- it is the commit marker load_model
        # keys on, so a crash between renames leaves either the old complete
        # checkpoint or no marker, never a marker pointing at stale weights.
        tmp = self._model_filepath + '.npz.tmp'
        with open(tmp, 'wb') as f:
            np.savez(f, **arrays)
        os.replace(tmp, self._model_filepath + '.npz')

        if rng_state is not None:
            tmp = self._random_state_filepath + '.tmp'
            with open(tmp, 'w') as f:
                json.dump(rng_state, f)
            os.replace(tmp, self._random_state_filepath)

        tmp = self._params_filepath + '.tmp'
        with open(tmp, 'w') as f:
            json.dump(params, f, **self.json_params)
        os.replace(tmp, self._params_filepath)

    def _writes_files(self):
        """Whether this process writes checkpoints and summaries (all but
        rank 0 of a mesh stay silent)."""
        return True

    def _save_model(self):
        # the state's arrays first, on every rank: on a mesh whose ranks
        # hold parts of the state (a DBM's particles, a tensor-parallel W)
        # they are gathered by a collective; one rank writes
        arrays = self._get_state_arrays()
        if self._writes_files():
            params, rng_state = self._checkpoint_payload()
            self._write_checkpoint(params, rng_state, arrays)

    @classmethod
    def load_model(cls, model_path, device=None):
        """Load a checkpoint directory (written by this package or by the
        JAX package) onto `device` (default: the CUDA device; raises where
        there is none)."""
        paths = TorchModel.compute_working_paths(model_path)

        with open(paths['params_filepath'], 'r') as f:
            params = json.load(f)
        class_name = params.pop('__class_name__')
        if class_name != cls.__name__:
            raise RuntimeError('attempt to load {0} with class {1}'
                               .format(class_name, cls.__name__))
        model = cls(paths=paths, device=device,
                    **{k: params[k] for k in params if is_param_name(k)})
        params = model._deserialize(params)
        model.set_params(**params)

        if os.path.isfile(model._random_state_filepath):
            with open(model._random_state_filepath, 'r') as f:
                model._rng.set_state(json.load(f))

        npz_path = model._model_filepath + '.npz'
        if os.path.isfile(npz_path):
            with np.load(npz_path) as data:
                model._set_state_arrays({k: data[k] for k in data.files})
        elif getattr(model, 'initialized_', False):
            # params.json (the commit marker) claims an initialized model but
            # the weights are missing -- refuse to hand back a model with
            # freshly-initialized weights
            raise IOError('checkpoint at {0} is marked initialized_ but '
                          '{1} is missing'.format(paths['model_dirpath'],
                                                  npz_path))
        return model

    # ------------------------------------------------------------------ #
    # lifecycle                                                           #
    # ------------------------------------------------------------------ #
    def _fit(self, X, X_val=None, *args, **kwargs):
        raise NotImplementedError

    def init(self):
        """Build (or keep) initial state and save."""
        self._ensure_state()
        if not self.initialized_:
            self.initialized_ = True
            self._save_model()
        return self

    def fit(self, X, X_val=None, *args, **kwargs):
        """Fit the model according to the given training data (the span
        ``fit``, its checkpoint ``fit/save``: ``utils/profiler.py``)."""
        with annotate('fit'):
            self._ensure_state()
            self.initialized_ = True
            self._fit(X, X_val=X_val, *args, **kwargs)
            with annotate('fit/save'):
                self._save_model()
        return self

    def get_params_arrays(self, scope=None):
        """Model parameters as a dict of numpy arrays.

        ``scope`` filters keys by prefix ('weights/W' -> scope='weights'
        yields key 'W')."""
        self._ensure_state()
        arrays = self._get_state_arrays()
        if scope is None:
            return arrays
        out = {}
        prefix = scope.rstrip('/') + '/'
        for k, v in arrays.items():
            if k.startswith(prefix):
                out[k[len(prefix):]] = v
        return out

    # alias matching the reference method name
    get_tf_params = get_params_arrays
