from .mesh import make_mesh, pad_batch, shard_features, shard_params
from .collectives import make_audit_step

__all__ = ["make_audit_step", "make_mesh", "pad_batch", "shard_features",
           "shard_params"]
