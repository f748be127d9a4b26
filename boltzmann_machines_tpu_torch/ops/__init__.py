from .cd_epoch import (cd_epoch, cd_epoch_reference, make_cd_epoch_kernel,
                       reset_launches)
from .philox import philox4x32, philox_uniform
