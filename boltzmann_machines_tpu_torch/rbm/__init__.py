from .base_rbm import BaseRBM
from .rbm import BernoulliRBM, GaussianRBM, MultinomialRBM, logit_mean
