"""The parallel layer on torch process groups (port of
``fs_uae_image_enhancer_project_tpu/parallel``): the (dp, sp) mesh, the
spatial split that stands in for XLA's halo exchange, the train step on one
card or over a mesh, sharded inference and the multi-process dry run."""
from .mesh import (  # noqa: F401
    Mesh,
    accum_batch_sharding,
    batch_sharding,
    init_process_group,
    make_mesh,
    replicate,
    replicated,
    shard_batch,
    spawn_ranks,
)
from .spatial import Halo, apply_split, gather_rows, model_halo  # noqa: F401
from .train_step import (  # noqa: F401
    TrainState,
    init_train_state,
    make_optimizer,
    make_train_step,
    merge_bn_buffers,
    split_bn_buffers,
)
