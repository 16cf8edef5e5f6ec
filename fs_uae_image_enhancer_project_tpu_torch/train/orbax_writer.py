"""Write orbax checkpoints the JAX package restores, without jax, orbax or
tensorstore.

The JAX trainer saves ``{"step", "params", "buffers", "opt_state"}`` with
orbax's ``StandardCheckpointer`` (``train/trainer.py`` there). This module
writes the same directory for a tree of numpy arrays, so that package's
``load_params`` and ``load_checkpoint`` (and tensorstore) read what the
port trained:

- ``_METADATA``: each leaf by its path, a key list (``key_type`` 2 for a
  dict key, 1 for a sequence index) and its value type: ``jax.Array`` with
  its ``write_shape``, or ``Dict`` (an empty dict) and ``None``, which orbax
  does not serialize;
- an OCDBT store at the top (:func:`..utils.ocdbt.write_store`) holding each
  array as zarr v2, named by its keys joined with dots: ``<name>/.zarray``
  (``<f4`` or ``<i4``, one chunk the whole shape, the ``zstd`` compressor, C
  order, no filters) and that chunk, ``<name>/0.0...`` (``0`` for a 0-d
  array), a zstd frame of raw blocks;
- ``array_metadatas/process_0`` and ``_CHECKPOINT_METADATA`` as orbax writes
  them. No ``_sharding``: orbax restores without it, and the committed
  checkpoints' device strings (``TPU v5 lite0``) are what the JAX package's
  ``load_params`` has to work around.

A leaf is a numpy array or scalar (``float32`` or ``int32``; others raise),
an empty dict or None; a dict key is a string and a list or tuple is a
sequence. ``write_orbax(path, tree)`` commits as orbax's ``force=True``
does, through a sibling directory: the tree is written into
``<path>.orbax-checkpoint-tmp-<hex>``, an existing ``path`` is renamed
aside to ``<path>.orbax-checkpoint-old-<hex>``, the new directory renamed
into place and the old one removed. So a write that fails leaves the
previous checkpoint whole, and a rewrite leaves no temporary directory. A
process that dies between the two renames leaves no ``path`` but the old
checkpoint whole beside it: :func:`committed` finds it there, and the next
write to ``path`` removes it.
"""
from __future__ import annotations

import glob
import json
import os
import shutil
import time
from typing import Any, List, Tuple

import numpy as np

from ..utils import zstd
from ..utils.ocdbt import write_store

__all__ = ["committed", "write_orbax"]

_ZARR_DTYPES = {np.dtype("<f4"): "<f4", np.dtype("<i4"): "<i4"}
_HANDLER = "orbax.checkpoint._src.handlers.standard_checkpoint_handler.StandardCheckpointHandler"
_DICT, _SEQUENCE = 2, 1


def _leaves(tree, keys=()) -> List[Tuple[tuple, Any]]:
    """(key list of (key, key_type), leaf) in jax's flattening order: dict
    keys sorted, sequences by index; an empty dict is a leaf."""
    if isinstance(tree, dict) and tree:
        return [x for k in sorted(tree) for x in _leaves(tree[k], keys + ((k, _DICT),))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in _leaves(v, keys + ((str(i), _SEQUENCE),))]
    return [(keys, tree)]


def _zarray(arr: np.ndarray) -> bytes:
    return json.dumps({
        "chunks": list(arr.shape), "compressor": {"id": "zstd", "level": 1},
        "dimension_separator": ".", "dtype": _ZARR_DTYPES[arr.dtype], "fill_value": None,
        "filters": None, "order": "C", "shape": list(arr.shape), "zarr_format": 2,
    }, separators=(",", ":")).encode()


def _write(path: str, tree: dict, t0: int) -> None:
    tree_meta, arrays, items = {}, [], {}
    for keys, leaf in _leaves(tree):
        if not keys or any(not isinstance(k, str) for k, _ in keys):
            raise TypeError(f"orbax keys are strings: {keys}")
        if isinstance(leaf, dict):
            value = {"value_type": "Dict", "skip_deserialize": True}
        elif leaf is None:
            value = {"value_type": "None", "skip_deserialize": True}
        else:
            arr = np.asarray(leaf)
            if arr.dtype.newbyteorder("<") not in _ZARR_DTYPES:
                raise TypeError(f"{keys}: dtype {arr.dtype}; only float32 and int32 are written")
            arr = arr.astype(arr.dtype.newbyteorder("<"), copy=False)  # tobytes: C order
            name = ".".join(k for k, _ in keys)
            shape = list(arr.shape)
            items[f"{name}/.zarray".encode()] = _zarray(arr)
            chunk = ".".join("0" * arr.ndim) if arr.ndim else "0"
            items[f"{name}/{chunk}".encode()] = zstd.compress(arr.tobytes())
            arrays.append({"array_metadata": {"param_name": name, "write_shape": shape,
                                              "chunk_shape": shape, "ext_metadata": None}})
            value = {"value_type": "jax.Array", "skip_deserialize": False, "write_shape": shape}
        tree_meta[str(tuple(k for k, _ in keys))] = {
            "key_metadata": [{"key": k, "key_type": t} for k, t in keys],
            "value_metadata": value}
    write_store(path, items)
    os.makedirs(os.path.join(path, "array_metadatas"))
    with open(os.path.join(path, "array_metadatas", "process_0"), "w") as f:
        json.dump({"array_metadatas": arrays}, f)
    with open(os.path.join(path, "_METADATA"), "w") as f:
        json.dump({"tree_metadata": tree_meta, "use_ocdbt": True, "use_zarr3": False,
                   "store_array_data_equal_to_fill_value": True, "custom_metadata": None}, f)
    with open(os.path.join(path, "_CHECKPOINT_METADATA"), "w") as f:
        json.dump({"item_handlers": _HANDLER, "metrics": {}, "performance_metrics": {},
                   "init_timestamp_nsecs": t0, "commit_timestamp_nsecs": time.time_ns(),
                   "custom_metadata": {}}, f)


def _set_aside(path: str) -> List[str]:
    return glob.glob(glob.escape(path) + ".orbax-checkpoint-old-*")


def committed(path: str) -> str:
    """Where the checkpoint ``path`` names is: ``path``, or, where a write
    died between its two renames and left no ``path``, the one previous
    checkpoint it had set aside beside it."""
    path = os.path.abspath(path)
    if not os.path.lexists(path):
        old = _set_aside(path)
        if len(old) == 1:
            return old[0]
    return path


def write_orbax(path: str, tree: dict) -> None:
    """Write ``tree`` (a dict of dicts, lists, numpy arrays, empty dicts and
    None) to the directory ``path`` as orbax's ``StandardCheckpointer``
    would with ``force=True``, replacing whatever ``path`` held only once
    the new checkpoint is whole."""
    t0 = time.time_ns()
    path = os.path.abspath(path)
    tag = os.urandom(8).hex()
    tmp = f"{path}.orbax-checkpoint-tmp-{tag}"
    os.makedirs(os.path.dirname(path), exist_ok=True)
    try:
        os.makedirs(tmp)
        _write(tmp, tree, t0)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    if os.path.lexists(path):
        os.rename(path, f"{path}.orbax-checkpoint-old-{tag}")
    os.rename(tmp, path)
    for old in _set_aside(path):
        shutil.rmtree(old) if os.path.isdir(old) else os.remove(old)
