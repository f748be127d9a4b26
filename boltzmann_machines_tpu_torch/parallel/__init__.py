from .mesh import make_mesh, shard_batch, shard_model_columns, replicate
from .distributed import initialize, process_local_slice
