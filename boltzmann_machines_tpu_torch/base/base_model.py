"""sklearn-style parameter protocol (reference base/base_model.py:8-67 analog)."""

import numpy as np
from copy import deepcopy

from .base import is_param_name, is_attribute_name
from .mixin import SeedMixin


class BaseModel(SeedMixin):
    def __init__(self, *args, **kwargs):
        super(BaseModel, self).__init__(*args, **kwargs)

    def get_params(self, deep=True, include_attributes=True):
        """Get hyperparameters (and optionally trailing-underscore attributes)."""
        params = vars(self)
        keep = lambda k: is_param_name(k) or (include_attributes and is_attribute_name(k))
        params = {k: params[k] for k in params if keep(k)}
        if deep:
            params = deepcopy(params)
        return params

    def set_params(self, **params):
        for k, v in params.items():
            if (is_param_name(k) or is_attribute_name(k)) and hasattr(self, k):
                setattr(self, k, v)
            else:
                raise ValueError("invalid param name '{0}'".format(k))
        return self

    @staticmethod
    def _to_jsonable(v):
        if isinstance(v, np.ndarray):
            return None if v.size > 1e6 else v.tolist()
        if isinstance(v, np.integer):
            return int(v)
        if isinstance(v, np.floating):
            return float(v)
        if isinstance(v, np.bool_):
            return bool(v)
        if isinstance(v, (list, tuple)):
            return [BaseModel._to_jsonable(x) for x in v]
        if isinstance(v, dict):
            return {k: BaseModel._to_jsonable(x) for k, x in v.items()}
        return v

    def _serialize(self, params):
        """Make params JSON-serializable (numpy scalars/arrays inside
        schedule lists included); arrays > 1e6 elements are dropped -- large
        learned tensors live in the array checkpoint instead."""
        for k, v in params.items():
            params[k] = self._to_jsonable(v)
        return params

    def _deserialize(self, params):
        return params
