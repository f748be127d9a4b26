"""PyTorch and CUDA port of boltzmann_machines_tpu, for NVIDIA Hopper.

The JAX package ``boltzmann_machines_tpu`` is the reference this package is
held against; this one imports neither JAX nor that package.  Its slices so
far are the Bernoulli, Gaussian and multinomial RBMs trained by CD-k and
the all-Bernoulli DBM trained by PCD with mean-field, with its sampler and
AIS log Z, and the RBMs' data-parallel epoch on ``torch.distributed``
(``parallel``; with a (data, model) mesh also tensor-parallel W, its hidden
columns split over the model axis): on a CUDA device they run in hand-written kernels
(``csrc/cd_epoch.cu`` and ``csrc/dbm_ops.cu``, built with nvcc on first
use), on the CPU -- asked for with ``device='cpu'`` -- in plain PyTorch.
DBMs with Gaussian or multinomial layers (the CIFAR pipelines'
Gaussian-Bernoulli-Multinomial DBM) run their plain program on the model's
device, their sampled layers drawn by the standalone sampler kernels on
CUDA.  The five example pipelines run end to end (examples/torch_*.py):
the fine-tuning MLP (``finetune``, Adam with per-layer rates from
``utils.optimizers``) in plain PyTorch, the models' histogram and image
summaries (``utils.plot_utils``), and CIFAR's x10 augmentation
(``utils.augmentation``).  Checkpoints load in both packages.
"""

__version__ = '0.1.0'

from . import base, parallel, utils
from .layers import BernoulliLayer, MultinomialLayer, GaussianLayer
from .ebm import EnergyBasedModel
from .rbm import (BaseRBM, BernoulliRBM, GaussianRBM, MultinomialRBM,
                  logit_mean)
from .dbm import DBM
from .convert import load_model
