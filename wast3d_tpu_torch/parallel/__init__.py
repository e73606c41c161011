"""Multi-rank rendering, training and stylization on `torch.distributed`
(port of `wast3d_tpu/parallel/`; `mesh.py` describes the process model)."""

from wast3d_tpu_torch.parallel.mesh import (  # noqa: F401
    make_mesh,
    scene_sharding,
    shard_train_state,
)
