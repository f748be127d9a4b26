from .base_rbm import BaseRBM
from .rbm import BernoulliRBM, logit_mean
