"""The host side of the CD epoch's C step loop (``bm_cd_epoch_loop`` in
boltzmann_machines_tpu_torch/csrc/cd_epoch.cu, called by ops/cd_epoch.py),
on the CPU: the launch schedule ``epoch_launches`` that the card test
holds the loop's own counts against, the ctypes mirror of the loop's
argument struct against the C source, and the loop's counters.  The loop
itself runs only on the card (tests/test_torch_cuda.py holds it against the
Python step loop it replaced, bit for bit)."""

import ctypes
import os
import re
import sys

import pytest

from boltzmann_machines_tpu_torch.ops.cd_epoch import (
    KERNELS, CDEpochConfig, EpochLoop, cd_epoch,
    epoch_launches, reset_launches)

CSRC = os.path.join(
    os.path.dirname(sys.modules[EpochLoop.__module__].__file__), os.pardir,
    'csrc', 'cd_epoch.cu')


def config(flavour, k, sample_v, sample_h, metrics_every, pll):
    kw = {'bernoulli': {}, 'gaussian': dict(visible='gaussian', sigma=1.5),
          'multinomial': dict(hidden='multinomial', n_samples=12)}[flavour]
    return CDEpochConfig(24, 16, k, sample_v, sample_h, 1., 1., 1e-4, 0.1,
                         0., 0.9, metrics_every, pll, **kw)


def counts(gemm, softmax, bias, assoc, metrics):
    return dict(zip(KERNELS, (gemm, softmax, bias, assoc, metrics, 0)))


# (flavour, k, sample_v, sample_h, metrics_every, PLL, NB, iter0, launches):
# the two launch-count card tests (test_launch_counts: iterations 2..7, one
# logged step without the PLL; test_flavour_launch_counts: a softmax launch
# after every hidden product, three logged steps of two launches); the
# rbm_mnist cell's two epoch calls at B 10 (5 and 6 logged steps of 1000)
# and its B 256 remainder call; k = 0; iter0 on and off a logged step
SCHEDULES = [
    ('bernoulli', 2, False, True, 4, False, 6, 1, counts(30, 0, 6, 6, 1)),
    ('multinomial', 2, True, True, 2, True, 6, 0, counts(30, 18, 6, 6, 6)),
    ('bernoulli', 1, False, True, 1000, True, 5500, 0,
     counts(16500, 0, 5500, 5500, 10)),
    ('bernoulli', 1, False, True, 1000, True, 5500, 5500,
     counts(16500, 0, 5500, 5500, 12)),
    ('bernoulli', 1, False, True, 1000, True, 1, 214, counts(3, 0, 1, 1, 0)),
    ('gaussian', 0, True, True, 3, True, 1, 2, counts(1, 0, 1, 1, 2)),
    ('gaussian', 0, True, True, 3, True, 1, 3, counts(1, 0, 1, 1, 0)),
    ('multinomial', 1, False, False, 1, False, 4, 7, counts(12, 8, 4, 4, 4)),
    ('multinomial', 0, True, True, 5, True, 9, 0, counts(9, 9, 9, 9, 2)),
]


@pytest.mark.parametrize('flavour,k,sample_v,sample_h,every,pll,NB,iter0,'
                         'want', SCHEDULES)
def test_epoch_launches(flavour, k, sample_v, sample_h, every, pll, NB,
                        iter0, want):
    cfg = config(flavour, k, sample_v, sample_h, every, pll)
    assert epoch_launches(cfg, NB, iter0) == want


@pytest.mark.parametrize('NB,iter0', [(1, 0), (7, 3), (40, 11)])
@pytest.mark.parametrize('every', [1, 2, 3, 7])
def test_epoch_launches_add_over_calls(NB, iter0, every):
    """An epoch cut into two calls (the fit's full batches, then the
    remainder) launches what it launches as one call."""
    cfg = config('multinomial', 1, True, True, every, True)
    whole = epoch_launches(cfg, NB + 1, iter0)
    parts = epoch_launches(cfg, NB, iter0), epoch_launches(cfg, 1,
                                                           iter0 + NB)
    assert whole == {n: parts[0][n] + parts[1][n] for n in whole}


def c_struct_fields(name):
    """[(field, kind)] of the struct `name` in csrc/cd_epoch.cu, in order;
    kind is 'ptr', 'int', 'long long', 'float' or 'unsigned'."""
    with open(CSRC) as f:
        src = f.read()
    body = re.search(r'struct %s \{(.*?)\n\};' % name, src, re.S).group(1)
    body = re.sub(r'//[^\n]*', '', body)
    out = []
    for decl in filter(None, (d.strip() for d in body.split(';'))):
        ctype, names = re.match(
            r'((?:const )?[a-z ]+?\**) ?(\w+(?:, *\w+)*)$', decl).groups()
        kind = 'ptr' if ctype.endswith('*') else ctype
        out += [(n.strip(), kind) for n in names.split(',')]
    return out


def test_epoch_loop_struct_mirrors_c():
    """EpochLoop's fields are CdEpochLoop's, in order and of the same C
    types, so ctypes lays out what the loop reads."""
    kinds = {ctypes.c_void_p: 'ptr', ctypes.c_int: 'int',
             ctypes.c_longlong: 'long long', ctypes.c_float: 'float',
             ctypes.c_uint: 'unsigned'}
    mirror = [(n, kinds[t]) for n, t in EpochLoop._fields_]
    assert mirror == c_struct_fields('CdEpochLoop')
    assert len(mirror) == 56


def test_reset_zeroes_loop_counts():
    """The loop's counts start at zero, ``reset_launches`` zeroes them, and
    the plain version on the CPU adds nothing to them."""
    import torch
    cfg = config('bernoulli', 1, False, True, 1, True)
    X = torch.zeros((2, 3, 24))
    state = {key: torch.zeros(shape) for key, shape in (
        ('W', (24, 16)), ('vb', (24,)), ('hb', (16,)), ('dW', (24, 16)),
        ('dvb', (24,)), ('dhb', (16,)), ('q_means', (16,)))}
    cd_epoch.loop.update(calls=3, steps=30)
    reset_launches()
    assert cd_epoch.loop == {'calls': 0, 'steps': 0}
    cd_epoch(cfg, state, X, 0.01, 0.9, 3, 0)
    assert cd_epoch.loop == {'calls': 0, 'steps': 0}
