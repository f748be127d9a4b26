"""Constructor-validation helpers (reference utils/testing.py:4-27 analog).

The nose runner is replaced by pytest; modules no longer self-run tests.
"""

import numpy as np


def assert_shape(obj, name, desired_shape):
    actual_shape = np.asarray(getattr(obj, name)).shape
    if actual_shape != tuple(desired_shape):
        raise ValueError('`{0}` has invalid shape {1} != {2}'
                         .format(name, actual_shape, tuple(desired_shape)))


def assert_len(obj, name, desired_len):
    actual_len = len(getattr(obj, name))
    if actual_len != desired_len:
        raise ValueError('`{0}` has invalid length {1} != {2}'
                         .format(name, actual_len, desired_len))
