"""Parameter / attribute naming protocol.

The whole persistence layer is driven by a naming convention on instance
attributes (mirrors reference boltzmann_machines/base/base.py:1-5):

* ``foo``  -- constructor hyperparameter, JSON-persisted;
* ``foo_`` -- learned / progress attribute (e.g. ``epoch_``), also persisted;
* ``_foo`` -- private, never persisted.
"""


def is_param_name(name):
    return not name.startswith('_') and not name.endswith('_')


def is_attribute_name(name):
    return not name.startswith('_') and name.endswith('_')
