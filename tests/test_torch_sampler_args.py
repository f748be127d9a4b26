"""The arguments of the port's standalone samplers (boltzmann_machines_tpu_
torch/ops/samplers.py) on the CPU: every seed form ``key_words`` accepts
gives the words of the JAX package's ``_seed_words`` (ops/pallas_ops.py),
written here as literals; the forms it refuses raise as they did; the
shapes ``normal_sample`` accepts; and a CPU tensor or ``device='cpu'``
runs the plain version and launches nothing.  The CUDA kernels are held
against the plain versions in tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

from boltzmann_machines_tpu.ops.pallas_ops import _seed_words
from boltzmann_machines_tpu_torch.ops.samplers import (
    bernoulli_sample, bernoulli_sample_reference, key_words, normal_sample,
    normal_sample_reference)

# (seed form, its words)
SEED_FORMS = [
    (7, (7, 0)),
    (0, (0, 0)),
    (2 ** 32 - 1, (2 ** 32 - 1, 0)),
    (np.int64(7), (7, 0)),
    (np.array(7, np.uint32), (7, 0)),
    (np.array([7, 99], np.uint32), (7, 99)),
    ((7, 99), (7, 99)),
    ([7, 2 ** 32 - 1], (7, 2 ** 32 - 1)),
    ((np.uint32(3), np.int64(4)), (3, 4)),
    (torch.tensor([7, 99]), (7, 99)),
    (torch.tensor(12345), (12345, 0)),
]
SEED_IDS = ['int', 'zero', 'int_max', 'np_int64', 'np_0d', 'np_uint32_pair',
            'tuple', 'list', 'tuple_of_np', 'tensor_pair', 'tensor_0d']


@pytest.mark.parametrize('seed,words', SEED_FORMS, ids=SEED_IDS)
def test_key_words_of_every_seed_form(seed, words):
    got = key_words(seed)
    assert got == words
    assert all(type(w) is int for w in got)
    # JAX, in 32 bits here, takes the words as uint32 (exact: they fit)
    words_u32 = np.asarray(seed.numpy() if isinstance(seed, torch.Tensor)
                           else seed).astype(np.uint32)
    assert tuple(int(w) for w in np.asarray(_seed_words(words_u32))) == words


@pytest.mark.parametrize('seed,match', [
    ((1, 2, 3), 'seed must be an int or two uint32 words'),
    (np.zeros((2, 2), np.uint32), 'seed must be an int or two uint32 words'),
    (-1, 'seed words must fit in 32 bits'),
    (2 ** 32, 'seed words must fit in 32 bits'),
    ((7, -1), 'seed words must fit in 32 bits'),
    ([2 ** 32, 0], 'seed words must fit in 32 bits'),
], ids=['three_words', 'four_words', 'negative', 'int_2_32',
        'negative_word', 'word_2_32'])
def test_key_words_rejects(seed, match):
    with pytest.raises(ValueError, match=match):
        key_words(seed)
    with pytest.raises(ValueError, match=match):
        bernoulli_sample(seed, torch.full((2, 3), 0.5))


@pytest.mark.parametrize('seed,words', SEED_FORMS, ids=SEED_IDS)
def test_bernoulli_sample_of_every_seed_form_on_cpu(seed, words):
    """The CPU runs the plain version under the key of `seed`, bit for bit
    the draws of that key, and launches nothing."""
    probs = torch.rand((7, 1001), generator=torch.Generator().manual_seed(2))
    before = dict(bernoulli_sample.launches)
    got = bernoulli_sample(seed, probs)
    assert torch.equal(got, bernoulli_sample_reference(seed, probs))
    assert torch.equal(got, bernoulli_sample_reference(words, probs))
    assert bernoulli_sample.launches == before
    assert got.dtype == torch.float32 and got.shape == probs.shape


@pytest.mark.parametrize('shape', [
    (np.int64(3), np.int32(5)), torch.Size([4, 6]), (11,), [2, 3, 4],
    ()], ids=['numpy_ints', 'torch_size', '1d', '3d_list', '0d'])
def test_normal_sample_shapes_on_cpu(shape):
    before = dict(normal_sample.launches)
    got = normal_sample(9, shape, device='cpu')
    want = normal_sample_reference(9, tuple(int(d) for d in shape))
    assert got.shape == want.shape == tuple(int(d) for d in shape)
    assert torch.equal(got, want)
    assert normal_sample.launches == before


def test_samplers_refuse_what_the_kernels_do_not_take():
    """Counts of 2^32 or more (an expanded tensor holds no memory), a seed
    past 32 bits, and devices other than the CPU and CUDA raise as
    before."""
    with pytest.raises(ValueError, match='must fit in 32 bits'):
        bernoulli_sample(7, torch.zeros(1).expand(2 ** 32))
    with pytest.raises(ValueError, match='must fit in 32 bits'):
        normal_sample(7, (2 ** 16, 2 ** 16), device='cpu')
    with pytest.raises(ValueError, match='must fit in 32 bits'):
        normal_sample(2 ** 32, (2, 2), device='cpu')
    with pytest.raises(ValueError, match='runs on CUDA'):
        bernoulli_sample(7, torch.zeros(3, device='meta'))
    with pytest.raises(ValueError, match='runs on CUDA'):
        normal_sample(7, (2, 2), device='meta')
