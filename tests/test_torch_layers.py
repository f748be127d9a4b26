"""The port's unit layers (boltzmann_machines_tpu_torch/layers.py) against
the JAX package's: activations on the same inputs, and the samplers'
statistics (the two draw different random numbers)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from boltzmann_machines_tpu import layers as jax_layers
from boltzmann_machines_tpu_torch import layers


@pytest.mark.parametrize('name,kwargs', [
    ('BernoulliLayer', {}),
    ('GaussianLayer', dict(sigma=[0.5, 1., 2., 1.5, 0.7, 1.2])),
    ('MultinomialLayer', dict(n_samples=7)),
])
def test_activation_matches_jax(name, kwargs):
    """Same x and b into both: agreement to 1e-6 (f32 transcendentals)."""
    rng = np.random.RandomState(0)
    x = rng.randn(5, 6).astype(np.float32)
    b = rng.randn(6).astype(np.float32)
    ours = getattr(layers, name)(6, **kwargs)
    ref = getattr(jax_layers, name)(6, **kwargs)
    np.testing.assert_allclose(
        ours.activation(torch.as_tensor(x), torch.as_tensor(b)).numpy(),
        np.asarray(ref.activation(jnp.asarray(x), jnp.asarray(b))),
        rtol=1e-6, atol=1e-6)
    cfg = ours.get_config()
    assert cfg == ref.get_config()
    assert type(layers.BaseLayer.from_config(cfg)) is type(ours)


def test_bernoulli_sample_frequencies():
    g = torch.Generator().manual_seed(0)
    means = torch.full((4000, 3), 0.25)
    means[:, 1] = 0.5
    means[:, 2] = 0.9
    s = layers.BernoulliLayer(3).sample(g, means)
    assert set(torch.unique(s).tolist()) <= {0., 1.}
    np.testing.assert_allclose(s.mean(0).numpy(), [0.25, 0.5, 0.9],
                               atol=0.03)


def test_multinomial_sample_is_exact_count():
    """Row sums are exactly n; column means match n * p
    (tests/test_rbm.py:274)."""
    n, H = 13, 5
    layer = layers.MultinomialLayer(H, n_samples=n)
    g = torch.Generator().manual_seed(1)
    p = torch.tensor([0.1, 0.2, 0.3, 0.15, 0.25])
    means = (n * p).repeat(3000, 1)
    counts = layer.sample(g, means)
    assert torch.all(counts >= 0)
    assert torch.all(counts.sum(1) == n)
    np.testing.assert_allclose(counts.mean(0).numpy(), (n * p).numpy(),
                               atol=0.1)


def test_gaussian_sample_moments():
    g = torch.Generator().manual_seed(2)
    layer = layers.GaussianLayer(2, sigma=[1., 3.])
    means = torch.tensor([[0.5, -1.]]).repeat(20000, 1)
    s = layer.sample(g, means)
    np.testing.assert_allclose(s.mean(0).numpy(), [0.5, -1.], atol=0.06)
    np.testing.assert_allclose(s.std(0).numpy(), [1., 3.], rtol=0.03)
