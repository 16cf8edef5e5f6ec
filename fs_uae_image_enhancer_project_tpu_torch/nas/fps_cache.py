"""FPS measurement cache keyed by canonical architecture config.

Port of ``fs_uae_image_enhancer_project_tpu/nas/fps_cache.py``, the
counterpart of the reference's ``model_performance_cache.json``
(optuna_study_opt_act.py:16-39): identical architectures across trials and
studies reuse the measured FPS instead of measuring again; failed
measurements are stored as 0.0 so broken configs are not re-measured
(optuna_study_opt_act.py:196-198).

Two deviations from the reference, both the JAX package's:

- Keys embed the measuring backend (``__backend__``): ``cuda:<device name>``
  when torch sees a card, else ``cpu``. A CPU run can then never seed a
  number that a study on the card would reuse, nor one card's number
  another's.
- ``FSE_FPS_CACHE_RETRY_FAILED=1`` makes remembered failures (0.0)
  re-measurable, for a failure that was transient rather than a broken
  config.

The default path is the working directory's ``model_performance_cache.json``,
as in the JAX package; the keys keep the two packages' entries apart.
"""
from __future__ import annotations

import json
import os
import threading
from typing import Any, Callable, Dict, Optional


def current_backend() -> str:
    """``cuda:<name of card 0>`` when torch sees a card, else ``cpu``."""
    import torch

    if torch.cuda.is_available():
        return f"cuda:{torch.cuda.get_device_name(0)}"
    return "cpu"


class FPSCache:
    def __init__(self, path: str = "model_performance_cache.json"):
        self.path = path
        self._lock = threading.Lock()
        self._data: Dict[str, float] = {}
        if os.path.isfile(path):
            try:
                with open(path) as f:
                    self._data = json.load(f)
            except Exception:
                self._data = {}

    @staticmethod
    def make_key(arch_params, backend: Optional[str] = None) -> str:
        """Canonical sorted-JSON key (optuna_study_opt_act.py:16-39),
        prefixed with the measuring backend (:func:`current_backend` unless
        given).

        ``arch_params`` is either a dict or an already-canonical string:
        callers pass ``models.configs.config_to_json(cfg)``, the single NAS
        cache-key serialization."""
        backend = backend or current_backend()
        if isinstance(arch_params, str):
            return json.dumps({"__backend__": backend, "config_json": arch_params},
                              sort_keys=True)
        return json.dumps({"__backend__": backend, **arch_params}, sort_keys=True, default=str)

    def get(self, arch_params: Dict[str, Any]) -> Optional[float]:
        val = self._data.get(self.make_key(arch_params))
        if val == 0.0 and os.environ.get("FSE_FPS_CACHE_RETRY_FAILED") == "1":
            return None  # remembered failure, but the caller wants a retry
        return val

    def put(self, arch_params: Dict[str, Any], fps: float) -> None:
        with self._lock:
            self._data[self.make_key(arch_params)] = float(fps)
            tmp = self.path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(self._data, f, indent=1, sort_keys=True)
            os.replace(tmp, self.path)

    def get_or_measure(self, arch_params: Dict[str, Any], measure: Callable[[], float]) -> float:
        cached = self.get(arch_params)
        if cached is not None:
            return cached
        try:
            fps = float(measure())
        except Exception:
            fps = 0.0  # remember failures (opt_act.py:196-198)
        self.put(arch_params, fps)
        return fps
