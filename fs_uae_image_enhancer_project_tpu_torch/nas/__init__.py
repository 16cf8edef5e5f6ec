"""Neural architecture search over conv6's activations: the search engine
(``search``), the FPS cache (``fps_cache``), the three studies (``studies``),
the cleanup of failed trials (``prune_failed``) and the plots
(``visualize``). Port of ``fs_uae_image_enhancer_project_tpu/nas``."""
from .fps_cache import FPSCache  # noqa: F401
from .search import (  # noqa: F401
    COMPLETE,
    FAIL,
    PRUNED,
    MedianPruner,
    NopPruner,
    RandomSampler,
    Study,
    TPESampler,
    Trial,
    TrialPruned,
    create_study,
)
