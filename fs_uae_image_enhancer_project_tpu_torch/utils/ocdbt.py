"""An OCDBT key-value store over a directory: a reader and a writer.

OCDBT (tensorstore's "optionally-cooperative distributed B+tree") is the
store orbax writes a checkpoint into: a manifest, a version tree and a B+tree
whose leaves hold each value inline or as a range of a data file. This
module reads and writes that format without tensorstore:

- every encoded manifest and node is ``magic (uint32 big-endian) | length
  (uint64) | version (varint) | compression (varint: 0 none, 1 zstd) |
  body | CRC-32C (uint32)``; the length and the CRC-32C over all before it
  are checked, and a zstd body goes through :mod:`.zstd`;
- the manifest (``manifest.ocdbt``, or the newest ``manifest.<16 hex>`` when
  its kind is ``numbered``) holds the config, the newest versions inline and
  references to version-tree nodes for older ones;
- a B+tree node holds its keys prefix-compressed against the previous key,
  and an interior entry names the prefix its whole subtree shares, which the
  child's keys leave out;
- a data file is named by a base path and a relative path from the store's
  directory, as orbax's ``ocdbt.process_<i>/d/<hash>`` layout uses.

Integers are little-endian and varints are LEB128. Columns of a node are
stored one field at a time over all its entries.

``OcdbtStore(path).list()`` gives the keys of the newest version in order,
``read(key)`` a value's bytes and ``versions()`` every version the version
tree records.

``write_store(path, items)`` writes a new store of one version (generation
1, inline in ``manifest.ocdbt``) under the config of the JAX package's
checkpoints (:data:`CONFIG`): values of at most ``max_inline_value_bytes``
inline, the others and every B+tree node in one data file ``d/<32 hex>``,
nodes and the manifest as zstd frames of raw blocks (:func:`.zstd.compress`).
One leaf holds every key unless it would decode to more than
``max_decoded_node_bytes``; then interior nodes index the leaves. Only
manifests and nodes carry a CRC-32C, so the pure-Python CRC never sees the
values' bytes. No torch, no tensorstore.
"""
from __future__ import annotations

import glob
import os
import time
from typing import Dict, List, Optional, Tuple

from . import zstd

__all__ = ["CONFIG", "OcdbtError", "OcdbtStore", "crc32c", "write_store"]

_MANIFEST_MAGIC = 0x0CDB3A2A
_VERSION_NODE_MAGIC = 0x0CDB1234
_BTREE_NODE_MAGIC = 0x0CDB20DE
_MANIFEST = "manifest.ocdbt"
# the config of the JAX package's checkpoints (each store draws its own uuid)
CONFIG = {"manifest_kind": "single", "max_inline_value_bytes": 1024,
          "max_decoded_node_bytes": 100_000_000, "version_tree_arity_log2": 4,
          "compression": {"id": "zstd", "level": 0}}


class OcdbtError(ValueError):
    """A store that is malformed, corrupt or of a kind this reader lacks."""


def _crc_table() -> List[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (0x82F63B78 if c & 1 else 0)
        table.append(c)
    return table


_CRC_TABLE = _crc_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli) of ``data``."""
    crc = 0xFFFFFFFF
    t = _CRC_TABLE
    for b in data:
        crc = t[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


class _Reader:
    def __init__(self, data: bytes, what: str):
        self.data, self.p, self.what = data, 0, what

    def byte(self) -> int:
        if self.p >= len(self.data):
            raise OcdbtError(f"{self.what} ends early")
        self.p += 1
        return self.data[self.p - 1]

    def varint(self) -> int:
        v = shift = 0
        while True:
            b = self.byte()
            v |= (b & 0x7F) << shift
            if b < 0x80:
                return v
            shift += 7
            if shift > 63:
                raise OcdbtError(f"{self.what}: varint too long")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def fixed(self, n: int) -> bytes:
        if self.p + n > len(self.data):
            raise OcdbtError(f"{self.what} ends early")
        self.p += n
        return self.data[self.p - n:self.p]

    def u64s(self, n: int) -> List[int]:
        return [int.from_bytes(self.fixed(8), "little") for _ in range(n)]

    def end(self) -> None:
        if self.p != len(self.data):
            raise OcdbtError(f"{self.what}: {len(self.data) - self.p} bytes left over")


def _decode(encoded: bytes, magic: int, what: str) -> bytes:
    """The body of an encoded manifest or node, its framing checked."""
    if len(encoded) < 18:
        raise OcdbtError(f"{what}: {len(encoded)} bytes is too short")
    got = int.from_bytes(encoded[:4], "big")
    if got != magic:
        raise OcdbtError(f"{what}: magic {got:#010x}, expected {magic:#010x}")
    length = int.from_bytes(encoded[4:12], "little")
    if length != len(encoded):
        raise OcdbtError(f"{what}: header says {length} bytes, found {len(encoded)}")
    want = int.from_bytes(encoded[-4:], "little")
    if crc32c(encoded[:-4]) != want:
        raise OcdbtError(f"{what}: CRC-32C mismatch")
    r = _Reader(encoded[:-4], what)
    r.p = 12
    version = r.varint()
    if version != 0:
        raise OcdbtError(f"{what}: format version {version}")
    compression = r.varint()
    body = encoded[r.p:-4]
    if compression == 0:
        return body
    if compression == 1:
        try:
            return zstd.decompress(body)
        except zstd.ZstdError as e:
            raise OcdbtError(f"{what}: {e}") from e
    raise OcdbtError(f"{what}: compression format {compression}")


def _data_files(r: _Reader) -> List[str]:
    """A data file table: each file's path from the store's directory."""
    n = r.varint()
    prefix = r.varints(n - 1) if n else []
    suffix = r.varints(n)
    base = r.varints(n)
    paths: List[str] = []
    for i in range(n):
        keep = prefix[i - 1] if i else 0
        if i and keep > len(paths[-1]):
            raise OcdbtError(f"{r.what}: data file prefix past the previous path")
        path = (paths[-1][:keep] if i else "") + r.fixed(suffix[i]).decode()
        if base[i] > len(path):
            raise OcdbtError(f"{r.what}: base path longer than the path")
        paths.append(path)
    return paths


def _file_ids(r: _Reader, n: int, files: List[str]) -> List[str]:
    ids = r.varints(n)
    if any(i >= len(files) for i in ids):
        raise OcdbtError(f"{r.what}: data file id out of range")
    return [files[i] for i in ids]


def _keys(r: _Reader, n: int, interior: bool) -> Tuple[List[bytes], List[int]]:
    prefix = r.varints(n - 1) if n else []
    suffix = r.varints(n)
    common = r.varints(n) if interior else []
    keys: List[bytes] = []
    for i in range(n):
        keep = prefix[i - 1] if i else 0
        if i and keep > len(keys[-1]):
            raise OcdbtError(f"{r.what}: key prefix past the previous key")
        keys.append((keys[-1][:keep] if i else b"") + r.fixed(suffix[i]))
    if any(c > len(k) for c, k in zip(common, keys)):
        raise OcdbtError(f"{r.what}: subtree prefix longer than its key")
    return keys, common


def _versions(r: _Reader, files: List[str]) -> List[dict]:
    """The columns of a version-tree leaf: one dict a version."""
    n = r.varint()
    gen = r.varints(n)
    height = [r.byte() for _ in range(n)]
    fid = _file_ids(r, n, files)
    off, length = r.varints(n), r.varints(n)
    num_keys, tree_bytes, indirect = r.varints(n), r.varints(n), r.varints(n)
    commit = r.u64s(n)
    return [{"generation_number": gen[i], "root_height": height[i],
             # an empty tree's root names no data file
             "root": (fid[i], off[i], length[i]) if fid[i] else None,
             "num_keys": num_keys[i], "num_tree_bytes": tree_bytes[i],
             "num_indirect_value_bytes": indirect[i], "commit_time": commit[i]}
            for i in range(n)]


def _version_refs(r: _Reader, files: List[str], height: Optional[int]) -> List[dict]:
    """References to version-tree nodes; ``height`` is the children's, or
    None where each reference stores its own (the manifest's)."""
    n = r.varint()
    gen = r.varints(n)
    fid = _file_ids(r, n, files)
    off, length = r.varints(n), r.varints(n)
    num_gen = r.varints(n)
    commit = r.u64s(n)
    heights = [r.byte() for _ in range(n)] if height is None else [height] * n
    return [{"generation_number": gen[i], "location": (fid[i], off[i], length[i]),
             "num_generations": num_gen[i], "commit_time": commit[i], "height": heights[i]}
            for i in range(n)]


class OcdbtStore:
    """The newest version of the OCDBT store in directory ``path``."""

    def __init__(self, path: str):
        self.path = os.path.abspath(path)
        self._files: Dict[str, bytes] = {}
        self._index: Optional[Dict[bytes, tuple]] = None
        encoded = self._file(_MANIFEST)
        r = _Reader(_decode(encoded, _MANIFEST_MAGIC, _MANIFEST), _MANIFEST)
        self.config = self._config(r)
        if self.config["manifest_kind"] == "numbered":
            r.end()
            numbered = sorted(glob.glob(os.path.join(self.path, "manifest." + "[0-9a-f]" * 16)))
            if not numbered:
                raise OcdbtError(f"{self.path}: numbered manifest kind but no manifest file")
            name = os.path.basename(numbered[-1])
            r = _Reader(_decode(self._file(name), _MANIFEST_MAGIC, name), name)
            # a numbered manifest stores its config with the kind "single"
            if self._config(r) != dict(self.config, manifest_kind="single"):
                raise OcdbtError(f"{self.path}: {name} has another config")
        files = _data_files(r)
        self._versions = _versions(r, files)
        self._version_nodes = _version_refs(r, files, None)
        r.end()
        if not self._versions:
            raise OcdbtError(f"{self.path}: the manifest holds no version")
        self.version = self._versions[-1]

    # -- files ---------------------------------------------------------------
    def _file(self, rel: str) -> bytes:
        if rel not in self._files:
            full = os.path.normpath(os.path.join(self.path, rel))
            if not full.startswith(self.path + os.sep):
                raise OcdbtError(f"data file {rel!r} outside the store")
            try:
                with open(full, "rb") as f:
                    self._files[rel] = f.read()
            except FileNotFoundError as e:
                raise OcdbtError(f"{self.path}: missing file {rel}") from e
        return self._files[rel]

    def _range(self, loc: Tuple[str, int, int]) -> bytes:
        rel, off, length = loc
        data = self._file(rel)
        if off + length > len(data):
            raise OcdbtError(f"{rel}: range {off}+{length} past its {len(data)} bytes")
        return data[off:off + length]

    # -- manifest and version tree ------------------------------------------
    @staticmethod
    def _config(r: _Reader) -> dict:
        uuid = r.fixed(16).hex()
        kind = r.varint()
        if kind not in (0, 1):
            raise OcdbtError(f"{r.what}: manifest kind {kind}")
        cfg = {"uuid": uuid, "manifest_kind": ("single", "numbered")[kind],
               "max_inline_value_bytes": r.varint(), "max_decoded_node_bytes": r.varint(),
               "version_tree_arity_log2": r.byte()}
        method = r.varint()
        if method == 0:
            cfg["compression"] = None
        elif method == 1:
            cfg["compression"] = {"id": "zstd",
                                  "level": int.from_bytes(r.fixed(4), "little", signed=True)}
        else:
            raise OcdbtError(f"{r.what}: compression method {method}")
        return cfg

    def versions(self) -> List[dict]:
        """Every version the version tree records, oldest first."""
        out: List[dict] = []

        def visit(ref):
            what = f"version node {ref['location']}"
            r = _Reader(_decode(self._range(ref["location"]), _VERSION_NODE_MAGIC, what), what)
            if r.byte() != self.config["version_tree_arity_log2"]:
                raise OcdbtError(f"{what}: another arity than the config's")
            height = r.byte()
            if height != ref["height"]:
                raise OcdbtError(f"{what}: height {height}, expected {ref['height']}")
            files = _data_files(r)
            if height == 0:
                out.extend(_versions(r, files))
            else:
                children = _version_refs(r, files, height - 1)
                r.end()
                for c in children:
                    visit(c)
                return
            r.end()

        for ref in self._version_nodes:
            visit(ref)
        return out + self._versions

    # -- B+tree --------------------------------------------------------------
    def _node(self, loc, height: int, prefix: bytes, index: Dict[bytes, tuple]) -> None:
        what = f"B-tree node {loc}"
        r = _Reader(_decode(self._range(loc), _BTREE_NODE_MAGIC, what), what)
        if r.byte() != height:
            raise OcdbtError(f"{what}: height differs from its parent's reference")
        files = _data_files(r)
        n = r.varint()
        keys, common = _keys(r, n, height > 0)
        if height > 0:
            fid = _file_ids(r, n, files)
            off, length = r.varints(n), r.varints(n)
            r.varints(3 * n)  # statistics: num_keys, num_tree_bytes, num_indirect_value_bytes
            r.end()
            for i in range(n):
                self._node((fid[i], off[i], length[i]), height - 1,
                           prefix + keys[i][:common[i]], index)
            return
        length = r.varints(n)
        kind = r.varints(n)
        if any(k > 1 for k in kind):
            raise OcdbtError(f"{what}: unknown value kind")
        m = sum(kind)
        fid = _file_ids(r, m, files)
        off = r.varints(m)
        j = 0
        for i in range(n):
            if kind[i]:
                index[prefix + keys[i]] = (fid[j], off[j], length[i])
                j += 1
            else:
                index[prefix + keys[i]] = (r.fixed(length[i]),)
        r.end()

    def _tree(self) -> Dict[bytes, tuple]:
        if self._index is None:
            index: Dict[bytes, tuple] = {}
            v = self.version
            if v["root"] is not None:
                self._node(v["root"], v["root_height"], b"", index)
            if len(index) != v["num_keys"]:
                raise OcdbtError(f"{self.path}: {len(index)} keys, the manifest says "
                                 f"{v['num_keys']}")
            self._index = index
        return self._index

    def list(self) -> List[bytes]:
        """The keys, in order."""
        return sorted(self._tree())

    def read(self, key) -> bytes:
        """The value of ``key`` (``bytes`` or ``str``); ``KeyError`` if absent."""
        if isinstance(key, str):
            key = key.encode()
        ref = self._tree()[key]
        return ref[0] if len(ref) == 1 else self._range(ref)


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------

def _varint(v: int) -> bytes:
    out = bytearray()
    while v >= 0x80:
        out.append(v & 0x7F | 0x80)
        v >>= 7
    out.append(v)
    return bytes(out)


def _varints(values) -> bytes:
    return b"".join(map(_varint, values))


def _common(a: bytes, b: bytes) -> int:
    """The length of the longest common prefix of ``a`` and ``b``."""
    n = min(len(a), len(b))
    i = 0
    while i < n and a[i] == b[i]:
        i += 1
    return i


def _encode(body: bytes, magic: int) -> bytes:
    """The framing :func:`_decode` checks: magic, length, format version 0,
    zstd (compression 1), the body as a zstd frame and the CRC-32C over all
    before it."""
    payload = _varint(1) + zstd.compress(body)
    head = magic.to_bytes(4, "big") + (12 + 1 + len(payload) + 4).to_bytes(8, "little")
    encoded = head + _varint(0) + payload
    return encoded + crc32c(encoded).to_bytes(4, "little")


def _file_table(paths: List[str]) -> bytes:
    """A data file table of ``paths`` (sorted), each under the empty base
    path, each sharing its prefix with the one before."""
    raw = [p.encode() for p in paths]
    keep = [_common(raw[i - 1], raw[i]) for i in range(1, len(raw))]
    suffix = [len(r) - (keep[i - 1] if i else 0) for i, r in enumerate(raw)]
    return (_varint(len(raw)) + _varints(keep) + _varints(suffix) + _varints([0] * len(raw))
            + b"".join(r[len(r) - n:] for r, n in zip(raw, suffix)))


def _key_columns(keys: List[bytes]) -> Tuple[bytes, bytes]:
    """A node's key columns: (prefix and suffix lengths, the suffixes)."""
    keep = [_common(keys[i - 1], keys[i]) for i in range(1, len(keys))]
    suffix = [k[keep[i - 1]:] if i else k for i, k in enumerate(keys)]
    return _varints(keep) + _varints(map(len, suffix)), b"".join(suffix)


def _leaf(items: List[Tuple[bytes, bytes]], prefix: int, inline_max: int,
          data_file: str, offsets: Dict[bytes, int]) -> bytes:
    """A leaf node's body: keys less their first ``prefix`` bytes, values
    inline or at ``offsets`` in ``data_file``."""
    indirect = [(k, v) for k, v in items if len(v) > inline_max]
    lengths, suffixes = _key_columns([k[prefix:] for k, _ in items])
    return b"".join([
        b"\0", _file_table([data_file] if indirect else []), _varint(len(items)), lengths,
        suffixes, _varints(len(v) for _, v in items),
        _varints(int(len(v) > inline_max) for _, v in items),
        _varints([0] * len(indirect)), _varints(offsets[k] for k, _ in indirect),
        b"".join(v for _, v in items if len(v) <= inline_max)])


def _interior(height: int, children: List[dict], prefix: int, data_file: str) -> bytes:
    """An interior node's body: each child by its first key and the prefix
    its whole subtree shares (less this node's first ``prefix`` bytes)."""
    lengths, suffixes = _key_columns([c["first"][prefix:] for c in children])
    return b"".join([
        bytes([height]), _file_table([data_file]), _varint(len(children)), lengths,
        _varints(len(c["prefix"]) - prefix for c in children), suffixes,
        _varints([0] * len(children)), _varints(c["offset"] for c in children),
        _varints(c["length"] for c in children),
        *(_varints(c[k] for c in children)
          for k in ("num_keys", "num_tree_bytes", "num_indirect_value_bytes"))])


def _groups(costs: List[int], limit: int) -> List[Tuple[int, int]]:
    """Consecutive ``[start, stop)`` runs of entries whose costs, plus a
    node's overhead, stay within ``limit``."""
    runs, start, used = [], 0, 256
    for i, c in enumerate(costs):
        if 256 + c > limit:
            raise OcdbtError(f"an entry of about {c} bytes exceeds a node's {limit}")
        if used + c > limit:
            runs.append((start, i))
            start, used = i, 256
        used += c
    return runs + [(start, len(costs))]


def write_store(path: str, items: Dict[bytes, bytes]) -> None:
    """Write ``items`` as a new OCDBT store in the directory ``path``
    (created if need be; it must hold no store yet) under :data:`CONFIG`."""
    if not items:
        raise OcdbtError("a store with no key is not written")
    inline_max, limit = CONFIG["max_inline_value_bytes"], CONFIG["max_decoded_node_bytes"]
    entries = sorted(items.items())
    data_file = "d/" + os.urandom(16).hex()
    blob = bytearray()
    offsets: Dict[bytes, int] = {}
    for k, v in entries:
        if len(v) > inline_max:
            offsets[k] = len(blob)
            blob += v
    indirect = len(blob)

    def put(body: bytes, magic: int) -> Tuple[int, int]:
        encoded = _encode(body, magic)
        blob.extend(encoded)
        return len(blob) - len(encoded), len(encoded)

    # leaves, then interior levels until one node holds the rest; a node
    # under a parent leaves out the prefix its subtree shares, the root none
    costs = [len(k) + 40 + (len(v) if len(v) <= inline_max else 0) for k, v in entries]
    runs = _groups(costs, limit)
    level, height = [], 0
    for a, b in runs:
        keys = [k for k, _ in entries[a:b]]
        prefix = _common(keys[0], keys[-1]) if len(runs) > 1 else 0
        offset, length = put(_leaf(entries[a:b], prefix, inline_max, data_file, offsets),
                             _BTREE_NODE_MAGIC)
        level.append(dict(first=keys[0], last=keys[-1], prefix=keys[0][:prefix], offset=offset,
                          length=length, num_keys=b - a, num_tree_bytes=length,
                          num_indirect_value_bytes=sum(len(v) for _, v in entries[a:b]
                                                       if len(v) > inline_max)))
    while len(level) > 1:
        height += 1
        runs = _groups([len(c["first"]) + 80 for c in level], limit)
        upper = []
        for a, b in runs:
            kids = level[a:b]
            prefix = _common(kids[0]["first"], kids[-1]["last"]) if len(runs) > 1 else 0
            offset, length = put(_interior(height, kids, prefix, data_file), _BTREE_NODE_MAGIC)
            upper.append(dict(first=kids[0]["first"], last=kids[-1]["last"],
                              prefix=kids[0]["first"][:prefix], offset=offset, length=length,
                              **{k: sum(c[k] for c in kids) + (length if k == "num_tree_bytes"
                                                                else 0)
                                 for k in ("num_keys", "num_tree_bytes",
                                           "num_indirect_value_bytes")}))
        level = upper
    (root,) = level

    manifest = b"".join([
        os.urandom(16), _varint(0), _varint(inline_max), _varint(limit),
        bytes([CONFIG["version_tree_arity_log2"]]),
        _varint(1) + CONFIG["compression"]["level"].to_bytes(4, "little", signed=True),
        _file_table([data_file]),
        # the one version: generation 1, its root, its statistics, the time
        _varint(1), _varint(1), bytes([height]), _varint(0), _varint(root["offset"]),
        _varint(root["length"]), _varint(root["num_keys"]), _varint(root["num_tree_bytes"]),
        _varint(indirect), time.time_ns().to_bytes(8, "little"),
        _varint(0)])  # no version-tree node
    if os.path.exists(os.path.join(path, _MANIFEST)):
        raise OcdbtError(f"{path} already holds a store")
    os.makedirs(os.path.join(path, "d"), exist_ok=True)
    with open(os.path.join(path, data_file), "wb") as f:
        f.write(blob)
    with open(os.path.join(path, _MANIFEST), "wb") as f:
        f.write(_encode(manifest, _MANIFEST_MAGIC))
