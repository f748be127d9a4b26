from .mesh import (make_mesh, shard_batch, shard_model_columns, replicate,
                   all_gather_rows)
from .distributed import initialize, process_local_slice
