"""Zstandard decompression (RFC 8878) in Python and numpy.

The JAX package's orbax checkpoints hold zstd frames twice over: tensorstore
compresses each OCDBT manifest and B-tree node with zstd, and each zarr chunk
of an array uses the ``zstd`` compressor. The machine with the card has no
zstd codec for Python, so the port decodes the format itself. This module
covers what a standard encoder writes:

- frame headers with or without the content size and the window descriptor,
  and skippable frames (skipped);
- raw, RLE and compressed blocks;
- literals that are raw, RLE, Huffman-coded in 1 or 4 streams, or treeless
  (the previous block's Huffman table);
- sequences whose literal-length, offset and match-length codes use the
  predefined, RLE, FSE-compressed or repeated tables, and the three repeat
  offsets;
- the XXH64 content checksum, verified when the frame carries one.

A frame with a dictionary ID raises :class:`ZstdError` naming the feature,
as does any malformed input. A Huffman stream decodes through numpy arrays
over its bit positions (each one's peek window and the position after its
symbol), so Python steps 16 symbols at a time and numpy fills in the rest:
the literals, most of a checkpoint's bytes, cost no Python work each. No
torch, no codec library.

``decompress(data)`` decodes every frame in ``data`` and joins the results.
``compress(data)`` writes the inverse the JAX package's checkpoints can be
read back from: one frame of raw blocks, each at most 128 KiB (the format's
``Block_Maximum_Size``), its header giving the content size and a 128 KiB
window, no content checksum. No entropy coder: the bytes are stored as they
are, and any zstd decoder reads them.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["ZstdError", "compress", "decompress", "xxh64"]

_MAGIC = 0xFD2FB528
_SKIPPABLE_MASK, _SKIPPABLE = 0xFFFFFFF0, 0x184D2A50
_BLOCK_MAX = 1 << 17
# the Window_Descriptor of a 2^17-byte window (exponent 7, mantissa 0): a
# block may then be as large as _BLOCK_MAX
_WINDOW_128K = 7 << 3


class ZstdError(ValueError):
    """A frame this decoder cannot or must not decode."""


# ---------------------------------------------------------------------------
# XXH64 (the frame's content checksum is its low 32 bits, seed 0)
# ---------------------------------------------------------------------------

_M64 = (1 << 64) - 1
_P1, _P2, _P3 = 11400714785074694791, 14029467366897019727, 1609587929392839161
_P4, _P5 = 9650029242287828579, 2870177450012600261


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


def _round(acc: int, lane: int) -> int:
    return (_rotl((acc + lane * _P2) & _M64, 31) * _P1) & _M64


def xxh64(data: bytes, seed: int = 0) -> int:
    """The 64-bit xxHash of ``data``."""
    n = len(data)
    p = 0
    if n >= 32:
        v1, v2 = (seed + _P1 + _P2) & _M64, (seed + _P2) & _M64
        v3, v4 = seed & _M64, (seed - _P1) & _M64
        stripes = n // 32
        lanes = np.frombuffer(data, "<u8", stripes * 4).reshape(stripes, 4).tolist()
        for a, b, c, d in lanes:
            v1, v2, v3, v4 = _round(v1, a), _round(v2, b), _round(v3, c), _round(v4, d)
        h = (_rotl(v1, 1) + _rotl(v2, 7) + _rotl(v3, 12) + _rotl(v4, 18)) & _M64
        for v in (v1, v2, v3, v4):
            h = ((h ^ _round(0, v)) * _P1 + _P4) & _M64
        p = stripes * 32
    else:
        h = (seed + _P5) & _M64
    h = (h + n) & _M64
    while p + 8 <= n:
        h = (_rotl(h ^ _round(0, int.from_bytes(data[p:p + 8], "little")), 27) * _P1
             + _P4) & _M64
        p += 8
    if p + 4 <= n:
        h = (_rotl(h ^ (int.from_bytes(data[p:p + 4], "little") * _P1 & _M64), 23) * _P2
             + _P3) & _M64
        p += 4
    while p < n:
        h = (_rotl(h ^ (data[p] * _P5 & _M64), 11) * _P1) & _M64
        p += 1
    h ^= h >> 33
    h = (h * _P2) & _M64
    h ^= h >> 29
    h = (h * _P3) & _M64
    return h ^ (h >> 32)


# ---------------------------------------------------------------------------
# bit readers
# ---------------------------------------------------------------------------

def _highbit(x: int) -> int:
    return x.bit_length() - 1


class _BackBits:
    """A backward bitstream (RFC 8878 §4.1): read from the last bit towards
    the first, past the last byte's padding; bits below the start read as
    zeros, and ``pos`` goes negative."""

    def __init__(self, buf: bytes):
        if not buf or buf[-1] == 0:
            raise ZstdError("bitstream without its end marker")
        self.buf = bytes(buf) + b"\0" * 8
        self.pos = (len(buf) - 1) * 8 + _highbit(buf[-1])

    def read(self, n: int) -> int:
        if n == 0:
            return 0
        self.pos -= n
        p = self.pos
        if p >= 0:
            q = p >> 3
            return (int.from_bytes(self.buf[q:q + 8], "little") >> (p & 7)) & ((1 << n) - 1)
        if p + n <= 0:
            return 0
        return (int.from_bytes(self.buf[:8], "little") & ((1 << (p + n)) - 1)) << -p


# ---------------------------------------------------------------------------
# FSE tables (§4.1)
# ---------------------------------------------------------------------------

def _read_fse_counts(data: bytes, p: int, max_symbol: int, max_log: int
                     ) -> Tuple[List[int], int, int]:
    """Normalized counts from an FSE table description at ``data[p:]``:
    ``(counts, accuracy_log, bytes_read)``."""
    acc = int.from_bytes(data[p:p + 4], "little")
    log = (acc & 15) + 5
    if log > max_log:
        raise ZstdError(f"FSE accuracy log {log} above {max_log}")
    bit = 4
    remaining = (1 << log) + 1
    threshold = 1 << log
    nbits = log + 1
    counts: List[int] = []

    def peek() -> int:
        q = p + (bit >> 3)
        return int.from_bytes(data[q:q + 8].ljust(8, b"\0"), "little") >> (bit & 7)

    while remaining > 1 and len(counts) <= max_symbol:
        v = peek()
        limit = (2 * threshold - 1) - remaining
        if (v & (threshold - 1)) < limit:
            count = v & (threshold - 1)
            bit += nbits - 1
        else:
            count = v & (2 * threshold - 1)
            if count >= threshold:
                count -= limit
            bit += nbits
        count -= 1
        remaining -= -count if count < 0 else count
        counts.append(count)
        if count == 0:
            while True:
                rep = peek() & 3
                bit += 2
                counts.extend([0] * rep)
                if rep != 3:
                    break
        while remaining < threshold:
            nbits -= 1
            threshold >>= 1
    if remaining != 1 or len(counts) > max_symbol + 1:
        raise ZstdError("corrupt FSE table description")
    nbytes = (bit + 7) >> 3
    if p + nbytes > len(data):
        raise ZstdError("FSE table description past its block")
    return counts, log, nbytes


def _fse_table(counts: Sequence[int], log: int) -> Tuple[List[int], List[int], List[int]]:
    """Decoding table ``(symbol, nb_bits, baseline)``, one entry a state."""
    size = 1 << log
    sym = [0] * size
    high = size - 1
    nxt = [0] * len(counts)
    for s, c in enumerate(counts):
        if c == -1:
            sym[high] = s
            high -= 1
            nxt[s] = 1
        else:
            nxt[s] = c
    step = (size >> 1) + (size >> 3) + 3
    pos = 0
    for s, c in enumerate(counts):
        for _ in range(max(c, 0)):
            sym[pos] = s
            pos = (pos + step) & (size - 1)
            while pos > high:
                pos = (pos + step) & (size - 1)
    if pos != 0:
        raise ZstdError("FSE counts do not fill the table")
    nb = [0] * size
    base = [0] * size
    for state in range(size):
        s = sym[state]
        x = nxt[s]
        nxt[s] += 1
        nb[state] = log - _highbit(x)
        base[state] = (x << nb[state]) - size
    return sym, nb, base


_LL_DEFAULT = [4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2,
               2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1]
_ML_DEFAULT = [1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
               1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1,
               -1, -1, -1, -1, -1]
_OF_DEFAULT = [1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
               -1, -1, -1, -1, -1]
_PREDEFINED = {"ll": _fse_table(_LL_DEFAULT, 6), "of": _fse_table(_OF_DEFAULT, 5),
               "ml": _fse_table(_ML_DEFAULT, 6)}
_MAX_SYMBOL = {"ll": 35, "of": 31, "ml": 52}
_MAX_LOG = {"ll": 9, "of": 8, "ml": 9}

_LL_BASE = list(range(16)) + [16, 18, 20, 22, 24, 28, 32, 40, 48, 64, 128, 256, 512,
                              1024, 2048, 4096, 8192, 16384, 32768, 65536]
_LL_BITS = [0] * 16 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16]
_ML_BASE = list(range(3, 35)) + [35, 37, 39, 41, 43, 47, 51, 59, 67, 83, 99, 131, 259,
                                 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539]
_ML_BITS = [0] * 32 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16]


# ---------------------------------------------------------------------------
# Huffman literals (§4.2)
# ---------------------------------------------------------------------------

_HUF_JUMP = 16  # symbols a step of the Python walk along a Huffman stream


class _Huffman:
    """A Huffman decoding table: ``sym[w]`` and ``nb[w]`` for every
    ``max_bits``-bit peek window ``w``."""

    def __init__(self, weights: List[int]):
        total = sum(1 << (w - 1) for w in weights if w > 0)
        if total == 0:
            raise ZstdError("Huffman weights all zero")
        max_bits = _highbit(total) + 1
        left = (1 << max_bits) - total
        if left & (left - 1):
            raise ZstdError("Huffman weights do not complete a tree")
        weights = list(weights) + [_highbit(left) + 1]
        if max_bits > 11:
            raise ZstdError(f"Huffman code of {max_bits} bits")
        bits = [max_bits + 1 - w if w > 0 else 0 for w in weights]
        rank_count = [0] * (max_bits + 2)
        for b in bits:
            rank_count[b] += 1
        size = 1 << max_bits
        sym = np.zeros(size, np.uint8)
        nb = np.zeros(size, np.int64)
        rank_idx = [0] * (max_bits + 2)
        for i in range(max_bits, 0, -1):
            rank_idx[i - 1] = rank_idx[i] + rank_count[i] * (1 << (max_bits - i))
            nb[rank_idx[i]:rank_idx[i - 1]] = i
        if rank_idx[0] != size:
            raise ZstdError("corrupt Huffman table")
        for s, b in enumerate(bits):
            if b:
                n = 1 << (max_bits - b)
                sym[rank_idx[b]:rank_idx[b] + n] = s
                rank_idx[b] += n
        self.max_bits, self.sym, self.nb = max_bits, sym, nb

    def decode(self, stream: bytes, n: int) -> bytes:
        """``n`` literals from one backward Huffman stream."""
        if n == 0:
            return b""
        if not stream or stream[-1] == 0:
            raise ZstdError("Huffman stream without its end marker")
        mb = self.max_bits
        end = (len(stream) - 1) * 8 + _highbit(stream[-1])
        b = np.frombuffer(bytes(stream) + b"\0\0\0", np.uint8).astype(np.int32)
        words = b[:-3] | b[1:-2] << 8 | b[2:-1] << 16  # 24 bits from each byte
        # window[p]: the max_bits bits below position p, zeros under the start
        lo = np.arange(-mb, end + 1 - mb, dtype=np.int32)
        window = (words[np.maximum(lo, 0) >> 3] >> (lo & 7)) & ((1 << mb) - 1)
        head = min(mb, end + 1)
        window[:head] = (int(words[0]) << np.arange(mb, mb - head, -1)) & ((1 << mb) - 1)
        # nxt[p]: the position after decoding at p; a position past the
        # stream's start goes to the sentinel end + 1, which stays there
        nxt = np.arange(end + 2, dtype=np.int32)
        nxt[:end + 1] -= self.nb[window].astype(np.int32)
        nxt[nxt < 0] = end + 1
        # walk the chain _HUF_JUMP symbols at a time in Python, then fill
        # in the positions between with numpy
        jump = nxt
        for _ in range(_HUF_JUMP.bit_length() - 1):
            jump = jump[jump]
        jump = jump.tolist()
        starts, pos = [], end
        for _ in range(n // _HUF_JUMP + 1):
            starts.append(pos)
            pos = jump[pos]
        chain = np.empty((len(starts), _HUF_JUMP), np.int32)
        chain[:, 0] = starts
        for k in range(1, _HUF_JUMP):
            chain[:, k] = nxt[chain[:, k - 1]]
        order = chain.reshape(-1)[:n + 1]
        if (order[:n] > end).any():
            raise ZstdError("Huffman stream ends before its literals")
        if order[n] != 0:
            raise ZstdError("Huffman stream not consumed exactly")
        return self.sym[window[order[:n]]].tobytes()


def _read_huffman_table(data: bytes, p: int) -> Tuple[_Huffman, int]:
    """A Huffman tree description at ``data[p:]``: ``(table, bytes_read)``."""
    head = data[p]
    if head >= 128:
        n = head - 127
        nbytes = (n + 1) // 2
        raw = data[p + 1:p + 1 + nbytes]
        if len(raw) < nbytes:
            raise ZstdError("Huffman weights past their block")
        weights = []
        for b in raw:
            weights += [b >> 4, b & 15]
        return _Huffman(weights[:n]), 1 + nbytes
    size = head
    if size == 0 or p + 1 + size > len(data):
        raise ZstdError("corrupt Huffman weight stream")
    blob = data[p + 1:p + 1 + size]
    counts, log, used = _read_fse_counts(blob, 0, 255, 6)
    sym, nb, base = _fse_table(counts, log)
    bits = _BackBits(blob[used:])
    s1, s2 = bits.read(log), bits.read(log)
    weights: List[int] = []
    while True:
        weights.append(sym[s1])
        s1 = base[s1] + bits.read(nb[s1])
        if bits.pos < 0:
            weights.append(sym[s2])
            break
        weights.append(sym[s2])
        s2 = base[s2] + bits.read(nb[s2])
        if bits.pos < 0:
            weights.append(sym[s1])
            break
        if len(weights) > 255:
            raise ZstdError("too many Huffman weights")
    if any(w > 11 for w in weights):
        raise ZstdError("Huffman weight above 11")
    return _Huffman(weights), 1 + size


# ---------------------------------------------------------------------------
# frames and blocks
# ---------------------------------------------------------------------------

class _FrameState:
    """What one block leaves to the next within a frame."""

    def __init__(self):
        self.huffman: Optional[_Huffman] = None
        self.tables = {"ll": None, "of": None, "ml": None}
        self.reps = [1, 4, 8]


def _literals(block: bytes, st: _FrameState) -> Tuple[bytes, int]:
    b0 = block[0]
    kind, fmt = b0 & 3, (b0 >> 2) & 3
    if kind in (0, 1):  # raw, RLE
        if fmt in (0, 2):
            size, head = b0 >> 3, 1
        elif fmt == 1:
            size, head = (b0 >> 4) + (block[1] << 4), 2
        else:
            size, head = (b0 >> 4) + (block[1] << 4) + (block[2] << 12), 3
        if kind == 0:
            lit = block[head:head + size]
            if len(lit) != size:
                raise ZstdError("raw literals past their block")
            return bytes(lit), head + size
        if head >= len(block):
            raise ZstdError("RLE literals past their block")
        return bytes([block[head]]) * size, head + 1
    nhead = (3, 3, 4, 5)[fmt]
    h = int.from_bytes(block[:nhead], "little")
    bits = (10, 10, 14, 18)[fmt]
    regen = (h >> 4) & ((1 << bits) - 1)
    comp = (h >> (4 + bits)) & ((1 << bits) - 1)
    four = fmt != 0
    p = nhead
    end = p + comp
    if end > len(block):
        raise ZstdError("compressed literals past their block")
    if kind == 2:
        st.huffman, used = _read_huffman_table(block, p)
        p += used
    elif st.huffman is None:
        raise ZstdError("treeless literals with no previous Huffman table")
    huf = st.huffman
    if not four:
        return huf.decode(block[p:end], regen), end
    s1, s2, s3 = (int.from_bytes(block[p + 2 * i:p + 2 * i + 2], "little") for i in range(3))
    p += 6
    s4 = end - p - s1 - s2 - s3
    if s4 < 0:
        raise ZstdError("corrupt literal jump table")
    per = (regen + 3) // 4
    out = []
    for i, s in enumerate((s1, s2, s3, s4)):
        n = per if i < 3 else regen - 3 * per
        out.append(huf.decode(block[p:p + s], n))
        p += s
    return b"".join(out), end


def _sequence_table(block: bytes, p: int, mode: int, name: str, st: _FrameState):
    if mode == 0:
        st.tables[name] = _PREDEFINED[name]
        return p
    if mode == 1:
        if p >= len(block):
            raise ZstdError("RLE sequence table past its block")
        if block[p] > _MAX_SYMBOL[name]:
            raise ZstdError(f"{name} RLE symbol out of range")
        st.tables[name] = ([block[p]], [0], [0])  # one state: the symbol, no bits
        return p + 1
    if mode == 2:
        counts, log, used = _read_fse_counts(block, p, _MAX_SYMBOL[name], _MAX_LOG[name])
        st.tables[name] = _fse_table(counts, log)
        return p + used
    if st.tables[name] is None:
        raise ZstdError(f"repeat {name} table with no previous table")
    return p


def _compressed_block(block: bytes, st: _FrameState, out: bytearray) -> None:
    lit, p = _literals(block, st)
    if p >= len(block):
        raise ZstdError("block ends before its sequences section")
    b0 = block[p]
    if b0 == 0:
        if p + 1 != len(block):
            raise ZstdError("bytes after an empty sequences section")
        out += lit
        return
    if b0 < 128:
        nseq, p = b0, p + 1
    elif b0 < 255:
        nseq, p = ((b0 - 128) << 8) + block[p + 1], p + 2
    else:
        nseq, p = block[p + 1] + (block[p + 2] << 8) + 0x7F00, p + 3
    modes = block[p]
    p += 1
    if modes & 3:
        raise ZstdError("reserved bits set in the sequence modes")
    p = _sequence_table(block, p, modes >> 6, "ll", st)
    p = _sequence_table(block, p, (modes >> 4) & 3, "of", st)
    p = _sequence_table(block, p, (modes >> 2) & 3, "ml", st)
    ll_sym, ll_nb, ll_base = st.tables["ll"]
    of_sym, of_nb, of_base = st.tables["of"]
    ml_sym, ml_nb, ml_base = st.tables["ml"]
    bits = _BackBits(block[p:])
    read = bits.read
    ll_s = read(_highbit(len(ll_sym)))
    of_s = read(_highbit(len(of_sym)))
    ml_s = read(_highbit(len(ml_sym)))
    reps = st.reps
    lp = 0
    for i in range(nseq):
        of_code, ll_code, ml_code = of_sym[of_s], ll_sym[ll_s], ml_sym[ml_s]
        if of_code > 31:
            raise ZstdError("offset code above 31")
        ofv = (1 << of_code) + read(of_code)
        ml = _ML_BASE[ml_code] + read(_ML_BITS[ml_code])
        ll = _LL_BASE[ll_code] + read(_LL_BITS[ll_code])
        if ofv > 3:
            off = ofv - 3
            reps[2], reps[1], reps[0] = reps[1], reps[0], off
        else:
            idx = ofv - 1 + (ll == 0)
            if idx == 0:
                off = reps[0]
            else:
                off = reps[idx] if idx < 3 else reps[0] - 1
                if idx > 1:
                    reps[2] = reps[1]
                reps[1], reps[0] = reps[0], off
        if i + 1 < nseq:
            ll_s = ll_base[ll_s] + read(ll_nb[ll_s])
            ml_s = ml_base[ml_s] + read(ml_nb[ml_s])
            of_s = of_base[of_s] + read(of_nb[of_s])
        if lp + ll > len(lit):
            raise ZstdError("sequence takes more literals than the block has")
        out += lit[lp:lp + ll]
        lp += ll
        n = len(out)
        if off == 0 or off > n:
            raise ZstdError(f"match offset {off} outside the {n} bytes decoded")
        start = n - off
        if off >= ml:
            out += out[start:start + ml]
        else:  # the match overlaps what it writes: repeat the period
            chunk = out[start:n]
            out += (chunk * (ml // off + 1))[:ml]
    if bits.pos != 0:
        raise ZstdError("sequence bitstream not consumed exactly")
    out += lit[lp:]


def _frame(data: bytes, p: int) -> Tuple[bytes, int]:
    """Decode the zstd frame at ``data[p:]`` (past its magic): ``(content,
    end)``."""
    if p >= len(data):
        raise ZstdError("truncated frame header")
    fhd = data[p]
    p += 1
    fcs_flag, single = fhd >> 6, (fhd >> 5) & 1
    if fhd & 8:
        raise ZstdError("reserved bit set in the frame header")
    checksum, dict_flag = (fhd >> 2) & 1, fhd & 3
    window = None
    if not single:
        wd = data[p]
        p += 1
        log = 10 + (wd >> 3)
        window = (1 << log) + ((1 << log) >> 3) * (wd & 7)
    if dict_flag:
        did = int.from_bytes(data[p:p + (0, 1, 2, 4)[dict_flag]], "little")
        if did:
            raise ZstdError(f"frame needs dictionary {did}; dictionaries are not supported")
        p += (0, 1, 2, 4)[dict_flag]
    fcs_size = (1 if single else 0, 2, 4, 8)[fcs_flag]
    size = None
    if fcs_size:
        size = int.from_bytes(data[p:p + fcs_size], "little") + (256 if fcs_size == 2 else 0)
        p += fcs_size
    if p > len(data):
        raise ZstdError("truncated frame header")
    block_max = min(window if window is not None else size, _BLOCK_MAX)
    st = _FrameState()
    out = bytearray()
    while True:
        if p + 3 > len(data):
            raise ZstdError("truncated block header")
        h = int.from_bytes(data[p:p + 3], "little")
        p += 3
        last, kind, bsize = h & 1, (h >> 1) & 3, h >> 3
        if kind == 1:
            if p >= len(data):
                raise ZstdError("truncated RLE block")
            out += bytes([data[p]]) * bsize
            p += 1
        else:
            if bsize > block_max:
                raise ZstdError(f"block of {bsize} bytes above the frame's {block_max}")
            block = data[p:p + bsize]
            if len(block) != bsize:
                raise ZstdError("truncated block")
            p += bsize
            if kind == 0:
                out += block
            elif kind == 2:
                _compressed_block(bytes(block), st, out)
            else:
                raise ZstdError("reserved block type")
        if last:
            break
    if size is not None and len(out) != size:
        raise ZstdError(f"frame content is {len(out)} bytes, its header says {size}")
    if checksum:
        if p + 4 > len(data):
            raise ZstdError("truncated content checksum")
        want = int.from_bytes(data[p:p + 4], "little")
        if xxh64(bytes(out)) & 0xFFFFFFFF != want:
            raise ZstdError("content checksum mismatch")
        p += 4
    return bytes(out), p


def decompress(data: bytes) -> bytes:
    """The content of every zstd frame in ``data``, in order; skippable
    frames are skipped."""
    data = bytes(data)
    parts = []
    p = 0
    while p < len(data):
        if p + 4 > len(data):
            raise ZstdError("truncated frame magic")
        magic = int.from_bytes(data[p:p + 4], "little")
        if magic == _MAGIC:
            content, p = _frame(data, p + 4)
            parts.append(content)
        elif magic & _SKIPPABLE_MASK == _SKIPPABLE:
            n = int.from_bytes(data[p + 4:p + 8], "little")
            p += 8 + n
            if p > len(data):
                raise ZstdError("truncated skippable frame")
        else:
            raise ZstdError(f"not a zstd frame (magic {magic:#010x})")
    return b"".join(parts)


def compress(data: bytes) -> bytes:
    """``data`` as one zstd frame of raw blocks of at most 128 KiB, with
    its content size in the header and no checksum."""
    view = memoryview(data).cast("B")
    n = len(view)
    fcs_flag, fcs_size = (2, 4) if n < 1 << 32 else (3, 8)
    parts = [_MAGIC.to_bytes(4, "little"), bytes([fcs_flag << 6, _WINDOW_128K]),
             n.to_bytes(fcs_size, "little")]
    for start in range(0, n, _BLOCK_MAX) or (0,):  # an empty input: one empty block
        size = min(_BLOCK_MAX, n - start)
        last = start + size == n
        parts += [(size << 3 | last).to_bytes(3, "little"), view[start:start + size]]
    return b"".join(parts)
