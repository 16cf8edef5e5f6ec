"""Read the JAX package's orbax checkpoints without jax, orbax or tensorstore.

The JAX trainer saves ``{"step", "params", "buffers", "opt_state"}`` with
orbax's ``StandardCheckpointer`` (``train/trainer.py`` there): an OCDBT store
(:mod:`..utils.ocdbt`) of zarr v2 arrays, one array a leaf, named by the
leaf's path joined with dots, plus ``_METADATA``, whose ``tree_metadata``
gives each leaf's path key by key. This module rebuilds the tree from those
key lists, never by splitting names at dots (a key may hold a dot):

- a ``jax.Array`` leaf is read from ``<name>/.zarray`` and
  its chunks ``<name>/<i>.<j>...`` (``0`` for a 0-d array);
- a ``Dict`` or ``None`` leaf that orbax does not serialize is ``{}`` or
  ``None``; a sequence key (``key_type`` 1, optax's state tuples) makes a
  list.

Arrays are in C order, of dtype ``<f4``, ``<i4``, ``<i8`` or ``bfloat16``
(widened to float32, which holds every bf16 value exactly), with a
``fill_value`` for chunks the store leaves out, and chunks compressed with
``zstd`` or not at all (:mod:`..utils.zstd`). Another compressor or any
filter raises :class:`OrbaxError`.

``read_orbax(path)`` returns ``{"step": ..., "params": ..., "buffers": ...}``
as numpy arrays. ``opt_state`` is left out unless ``subtrees`` names it: its
layout depends on the run's optimizer, and the port's resume starts a fresh
one, as the JAX package's does. ``buffers`` is ``{}`` where the JAX trainer
saved its ``{"__empty__": zeros(1)}`` sentinel for a model without
batchnorm.
"""
from __future__ import annotations

import itertools
import json
import math
import os
from typing import Iterable, Sequence

import numpy as np

from ..utils import zstd
from ..utils.ocdbt import OcdbtStore

__all__ = ["EMPTY_BUFFERS", "OrbaxError", "is_orbax_checkpoint", "read_orbax"]

_DTYPES = {"<f4": np.dtype("<f4"), "<i4": np.dtype("<i4"), "<i8": np.dtype("<i8"),
           "bfloat16": np.dtype("<u2")}
_FILLS = {"NaN": np.nan, "Infinity": np.inf, "-Infinity": -np.inf}
# the buffers of a model without batchnorm, as the JAX trainer saves them
EMPTY_BUFFERS = "__empty__"


class OrbaxError(ValueError):
    """A checkpoint this reader cannot decode."""


def is_orbax_checkpoint(path: str) -> bool:
    """Whether ``path`` is a directory orbax wrote with OCDBT."""
    return (os.path.isfile(os.path.join(path, "_METADATA"))
            and os.path.isfile(os.path.join(path, "manifest.ocdbt")))


def _decode_chunk(raw: bytes, meta: dict, name: str) -> np.ndarray:
    comp = meta.get("compressor")
    if comp is not None:
        if comp.get("id") != "zstd":
            raise OrbaxError(f"{name}: compressor {comp.get('id')!r}; only zstd is read")
        raw = zstd.decompress(raw)
    dtype = _DTYPES[meta["dtype"]]
    chunks = tuple(meta["chunks"])
    want = math.prod(chunks) * dtype.itemsize
    if len(raw) != want:
        raise OrbaxError(f"{name}: a chunk of {len(raw)} bytes, expected {want}")
    return np.frombuffer(raw, dtype).reshape(chunks)


def _read_array(store: OcdbtStore, name: str) -> np.ndarray:
    try:
        meta = json.loads(store.read(f"{name}/.zarray"))
    except KeyError as e:
        raise OrbaxError(f"array {name!r} not in the checkpoint") from e
    if meta.get("zarr_format") != 2:
        raise OrbaxError(f"{name}: zarr format {meta.get('zarr_format')}; only v2 is read")
    if meta["dtype"] not in _DTYPES:
        raise OrbaxError(f"{name}: dtype {meta['dtype']!r}; "
                         f"only {', '.join(_DTYPES)} are read")
    if meta.get("filters"):
        raise OrbaxError(f"{name}: zarr filters {meta['filters']} are not read")
    if meta.get("order") != "C":
        raise OrbaxError(f"{name}: order {meta.get('order')!r}; only C order is read")
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    if len(shape) != len(chunks):
        raise OrbaxError(f"{name}: shape {shape} and chunks {chunks} differ in rank")
    dtype = _DTYPES[meta["dtype"]]
    fill = meta.get("fill_value")
    fill = 0 if fill is None else _FILLS.get(fill, fill)
    bf16 = meta["dtype"] == "bfloat16"
    out = np.empty(shape, np.float32 if bf16 else dtype)
    sep = meta.get("dimension_separator", ".")
    grid = [range(-(-s // c)) for s, c in zip(shape, chunks)]
    for idx in itertools.product(*grid):
        key = f"{name}/{sep.join(map(str, idx)) if idx else '0'}"
        region = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(idx, chunks, shape))
        try:
            raw = store.read(key)
        except KeyError:
            out[region] = fill
            continue
        chunk = _decode_chunk(raw, meta, key)
        chunk = chunk[tuple(slice(0, r.stop - r.start) for r in region)]
        out[region] = (chunk.astype(np.uint32) << 16).view(np.float32) if bf16 else chunk
    return out


def _set(tree, path, leaf) -> None:
    """Put ``leaf`` at ``path``, a list of (key, key_type), making dicts
    (key_type 2) and lists (1) on the way."""
    node = tree
    for depth, (key, key_type) in enumerate(path):
        last = depth == len(path) - 1
        child_type = None if last else path[depth + 1][1]
        if isinstance(node, list):
            key = int(key)
            while len(node) <= key:
                node.append(None)
            if last:
                node[key] = leaf
            elif node[key] is None:
                node[key] = {} if child_type == 2 else []
            node = None if last else node[key]
        else:
            if last:
                node[key] = leaf
            else:
                node = node.setdefault(key, {} if child_type == 2 else [])


def read_orbax(path: str, subtrees: Iterable[str] = ("step", "params", "buffers")) -> dict:
    """The subtrees ``subtrees`` of the orbax checkpoint at ``path`` as a
    nested dict of numpy arrays (lists for sequence keys)."""
    path = os.path.abspath(path)
    if not is_orbax_checkpoint(path):
        raise OrbaxError(f"{path} is not an orbax checkpoint (no _METADATA and manifest.ocdbt)")
    with open(os.path.join(path, "_METADATA")) as f:
        meta = json.load(f)
    if meta.get("use_zarr3"):
        raise OrbaxError(f"{path}: zarr v3 arrays are not read")
    store = OcdbtStore(path)
    wanted = set(subtrees)
    tree: dict = {}
    for entry in meta["tree_metadata"].values():
        keys = [(k["key"], k["key_type"]) for k in entry["key_metadata"]]
        if not keys or keys[0][0] not in wanted:
            continue
        value = entry["value_metadata"]
        kind = value["value_type"]
        if kind == "jax.Array":
            leaf = _read_array(store, ".".join(k for k, _ in keys))
        elif kind == "Dict" and value.get("skip_deserialize"):
            leaf = {}
        elif kind == "None":
            leaf = None
        else:
            raise OrbaxError(f"{path}: leaf {entry['key_metadata']} of type {kind!r}")
        _set(tree, keys, leaf)
    missing = wanted - set(tree)
    if missing:
        raise OrbaxError(f"{path}: no subtree {sorted(missing)}")
    buffers = tree.get("buffers")
    if isinstance(buffers, dict) and EMPTY_BUFFERS in buffers:
        tree["buffers"] = {}
    return tree
