"""PyTorch and CUDA port of boltzmann_machines_tpu, for NVIDIA Hopper.

The JAX package ``boltzmann_machines_tpu`` is the reference this package is
held against; this one imports neither JAX nor that package.  Its slices so
far are the Bernoulli, Gaussian and multinomial RBMs trained by CD-k and
the all-Bernoulli DBM trained by PCD with mean-field, with its sampler and
AIS log Z, and the RBMs' data-parallel epoch on ``torch.distributed``
(``parallel``): on a CUDA device they run in hand-written kernels
(``csrc/cd_epoch.cu`` and ``csrc/dbm_ops.cu``, built with nvcc on first
use), on the CPU -- asked for with ``device='cpu'`` -- in plain PyTorch.
Checkpoints load in both packages.
"""

__version__ = '0.1.0'

from . import base, parallel, utils
from .layers import BernoulliLayer, MultinomialLayer, GaussianLayer
from .ebm import EnergyBasedModel
from .rbm import (BaseRBM, BernoulliRBM, GaussianRBM, MultinomialRBM,
                  logit_mean)
from .dbm import DBM
from .convert import load_model
