from .base import is_param_name, is_attribute_name
from .base_model import BaseModel
from .mixin import BaseMixin, DtypeMixin, SeedMixin
from .torch_model import TorchModel
