"""Training on one card (port of ``fs_uae_image_enhancer_project_tpu/
parallel``'s single-device half; the mesh, sharded inference and the dryrun
are not ported yet)."""
from .train_step import (  # noqa: F401
    TrainState,
    init_train_state,
    make_optimizer,
    make_train_step,
    merge_bn_buffers,
    split_bn_buffers,
)
