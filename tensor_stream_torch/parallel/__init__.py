"""Multi-device scaling, the port of the JAX package's ``parallel``
package: meshes and DTensor layouts, the sharded VPP and the sharded
TransformerNet step (``sharding.py``), GPipe over VideoViT's blocks
(``pipeline.py``) and gradient accumulation (``accum.py``). Importing it
registers the ``ts`` operators' DTensor sharding rules (``_rules.py``)."""
from .accum import accumulate_gradients
from .pipeline import (init_pp_params, make_pp_mesh, make_pp_train_step,
                       pp_apply, shard_pp_params)
from .sharding import (build_train_step, make_mesh, make_train_state,
                       multi_stream_round_robin, param_sharding,
                       vpp_batch_sharded)

__all__ = ["accumulate_gradients", "build_train_step", "init_pp_params",
           "make_mesh", "make_pp_mesh", "make_pp_train_step",
           "make_train_state", "multi_stream_round_robin", "param_sharding",
           "pp_apply", "shard_pp_params", "vpp_batch_sharded"]
