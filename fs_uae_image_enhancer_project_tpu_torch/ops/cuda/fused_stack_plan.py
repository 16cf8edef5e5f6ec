"""The plan of the fused-stack kernels K1 and K2, mirrored in Python.

``csrc/fused_stack_common.cuh`` fixes the plan at compile time: the output
tile, the regions of the seven layers, the shared-memory buffers, the ring
through which each layer's weights are staged, and the units of work (m-tile,
group of n-tiles) that go round robin over the CTA's warps. The kernel's
``static_assert``-s hold it on the card; this mirror lets the CPU tests check
what the kernel relies on (every output pixel written once, the buffers and
the ring within the 227 KB a block may take and apart from what a layer
reads or writes, the ring's chunks covering each layer's weights, l1's
compacted window holding all that layer 6 reads), and ``chip_smoke.py``
holds it to the compiled kernel's own report (``fse_fused_stack_info``).
``pk`` is the GEMM form: 1 for K1 (a pixel a matmul row), 2 for K2 (a pair).
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Tuple

TILE = (16, 14)  # output tile rows, columns (FSE_TILE_H, FSE_TILE_W)
NWARPS = 12
NT_GROUP = 9  # most 8-column n-tiles one unit holds
SMEM_LIMIT = 232_448
PARAM_FLOATS = 552
# channel strides in shared memory (elements): input, 36-channel, 72-channel
STRIDES = {1: (24, 40, 72), 2: (20, 44, 76)}
SLICE_BYTES_PER_NTILE = 32 * 8  # a k-step's B fragments for one n-tile


class Layer(NamedTuple):
    out: int     # layer whose region the conv computes (1-7)
    geo: int     # layer whose region geometry its sources have
    stride: int  # channel stride of its sources
    cpt: int     # chunks of 8 channels per tap per source
    nsrc: int    # sources (2 for layer 6: l1's window and l5)
    nt: int      # n-tiles of 8 columns
    ks: int      # k-steps of 16

    @property
    def weight_bytes(self) -> int:
        return self.ks * self.nt * SLICE_BYTES_PER_NTILE


def layers(pk: int) -> List[Layer]:
    """The seven convs of the stack in form ``pk``."""
    s_in, s36, s72 = STRIDES[pk]
    n36, n72, n12 = (5, 9, 2) if pk == 1 else (9, 18, 3)
    spec = [(1, 0, s_in, 2, 1, n36), (2, 1, s36, 5, 1, n36), (3, 2, s36, 5, 1, n72),
            (4, 3, s72, 9, 1, n72), (5, 4, s72, 9, 1, n36), (6, 5, s36, 5, 2, n36),
            (7, 6, s36, 5, 1, n12)]
    return [Layer(o, g, st, c, ns, nt, (ns * 3 * (pk + 2) * c + 1) // 2)
            for o, g, st, c, ns, nt in spec]


def region(layer: int, tile) -> Tuple[int, int]:
    """(rows, columns) of layer ``layer``'s region: halo 7 - layer a side."""
    return tile[0] + 2 * (7 - layer), tile[1] + 2 * (7 - layer)


def _align16(b: int) -> int:
    return (b + 15) // 16 * 16


def region_bytes(layer: int, stride: int, tile) -> int:
    rows, cols = region(layer, tile)
    return _align16(rows * cols * stride * 2)


def smem(pk: int, tile=None) -> Dict[str, Tuple[int, int]]:
    """The CTA's shared-memory buffers, name -> (byte offset, bytes), as
    ``Smem<PK>``: B (in, l2, l4, l6), C (l3, l5; ring12 before them), A (l1)
    whose front A1C keeps l1's window from layer 3 on, ring3 after A1C, P."""
    tile = tile or TILE
    s_in, s36, s72 = STRIDES[pk]
    a = region_bytes(1, s36, tile)
    a1c = region_bytes(5, s36, tile)
    b = max(region_bytes(0, s_in, tile), region_bytes(2, s36, tile),
            region_bytes(4, s72, tile), region_bytes(6, s36, tile))
    c = max(region_bytes(3, s72, tile), region_bytes(5, s36, tile))
    p = _align16(PARAM_FLOATS * 4)
    off_ring3 = b + c + a1c
    ring3 = (SMEM_LIMIT - p - off_ring3) // 256 * 256
    return {"B": (0, b), "C": (b, c), "A": (b + c, a), "A1C": (b + c, a1c),
            "ring12": (b, c), "ring3": (off_ring3, ring3), "P": (off_ring3 + ring3, p)}


def smem_bytes(pk: int, tile=None) -> int:
    off, n = smem(pk, tile)["P"]
    return off + n


# the buffers each layer reads or writes while its weights are in the ring
LIVE = {1: ("B", "A", "P"), 2: ("A", "B", "P"), 3: ("B", "C", "A1C", "P"),
        4: ("C", "B", "A1C", "P"), 5: ("B", "C", "A1C", "P"), 6: ("A1C", "C", "B", "P"),
        7: ("B", "P")}


def ring_name(layer: int) -> str:
    return "ring12" if layer <= 2 else "ring3"


def ring_chunks(pk: int, layer: int, tile=None) -> List[Tuple[int, int, int]]:
    """(first k-step, k-steps, byte offset in the ring) of each chunk of the
    layer's weights, as ``Ring<NT, KS, BYTES>``: the whole matrix if it fits
    the ring, else chunks of KC k-steps alternating between its halves."""
    ly = layers(pk)[layer - 1]
    ring = smem(pk, tile)[ring_name(layer)][1]
    slice_bytes = ly.nt * SLICE_BYTES_PER_NTILE
    kc = ly.ks if ly.weight_bytes <= ring else (ring // 2) // slice_bytes
    if kc < 1:
        raise ValueError(f"layer {layer}: a k-step's slice does not fit half the ring")
    return [(k0, min(kc, ly.ks - k0), (c % 2) * kc * slice_bytes)
            for c, k0 in enumerate(range(0, ly.ks, kc))]


def geometry(pk: int, layer: int, tile=None):
    """(matmul rows, m-tiles, n-groups, n-tiles a group) of a layer."""
    ly = layers(pk)[layer - 1]
    rows, cols = region(layer, tile or TILE)
    nrows = rows * cols // pk
    ng = -(-ly.nt // NT_GROUP)
    return nrows, -(-nrows // 16), ng, ly.nt // ng


def units(pk: int, layer: int, tile=None) -> List[List[Tuple[int, int]]]:
    """Per warp, its units (m-tile, n-group) of the layer: unit u goes to
    warp u % NWARPS, as m-tile u // NG and group u % NG."""
    _, mtiles, ng, _ = geometry(pk, layer, tile)
    return [[(u // ng, u % ng) for u in range(w, mtiles * ng, NWARPS)] for w in range(NWARPS)]


def row_pixels(pk: int, layer: int, r: int, tile=None) -> Tuple[int, int]:
    """(y, x) in the layer's region of matmul row ``r``'s first pixel."""
    cols = region(layer, tile or TILE)[1]
    wq = cols // pk
    return r // wq, (r % wq) * pk


def grid(h2: int, w2: int, tile) -> Tuple[int, int]:
    """CTAs along the columns and the rows of one frame."""
    return -(-w2 // tile[1]), -(-h2 // tile[0])


def waves(h2: int, w2: int, tile, frames: int = 1, sms: int = 132) -> float:
    """CTAs over SMs at one CTA an SM."""
    gx, gy = grid(h2, w2, tile)
    return gx * gy * frames / sms


def weight_bytes_per_cta(pk: int) -> int:
    """Bytes of weights a CTA reads from global memory: each layer's once."""
    return sum(ly.weight_bytes for ly in layers(pk))
