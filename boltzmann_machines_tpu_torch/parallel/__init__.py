from .mesh import (make_mesh, shard_batch, shard_model_columns, replicate,
                   all_gather_rows, all_gather_columns, column_blocks,
                   column_block)
from .distributed import initialize, process_local_slice
