"""K4: the lane-packing matmul study as one CUDA kernel.

Counterpart of ``scripts/bench_lane_packing.py::_mm_kernel`` (called through
its ``_run``). For ``a`` (m, k) fp32 and ``w`` (k, n) bf16 it computes, per
row, from ``acc = 0``, ``reps * grid`` times
``acc = (bf16(a) @ w) * 1e-4 + acc * 0.5`` in fp32, then
``o = a * 0.999 + 1e-7 * rowsum(acc)``, and returns ``(o, acc)``.

The Pallas kernel reads its accumulator scratch before anything writes it:
in interpret mode that is NaN, on the TPU whatever VMEM held, and each of
the 8 grid steps' halvings shrinks a finite start to 2^-(8 grid) of itself,
nothing at the script's grid of 64. So the port starts from zero, which is
what the TPU's result equals. ``o``'s second term is about 1e-10 with the
script's data, below fp32's rounding of ``a * 0.999``: ``o`` cannot show
whether the products are right, so the accumulator is returned and held to
the plain version.

- :func:`lane_packing_mm` is the kernel's wrapper; a CUDA tensor launches it
  (or raises), a CPU tensor takes :func:`lane_packing_mm_plain`. Its
  launches are counted in ``lane_packing_mm.launches``.
- :func:`lane_packing_mm_plain` is the chain in fp32 on bf16-rounded ``a``
  and ``w``, the product taken anew at each step as the kernel does.
- :func:`tile_plan` picks the kernel's plan for a shape: the columns a CTA
  (one ``wgmma`` N), whether W stays resident in shared memory or streams
  through a ring, and the ring's chunks.
- :func:`prepare_weight` lays W out as the exact bytes of the kernel's
  shared-memory image (K-major core matrices, 32-byte swizzle).
- :data:`CASES` are the bench's 12 GEMM shapes, (layer class, variant, m,
  k, n): per class the baseline (m, 9 cin) x (9 cin, cout), packed-2
  (m/2, 12 cin) x (12 cin, 2 cout) and packed-3 (m/3, 18 cin) x
  (18 cin, 3 cout).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

# m = STRIP(24) * wp(384): one fused-stack strip's matmul rows on the TPU
M_FULL = 24 * 384
REPS = 8  # products per grid step
SMS = 132  # the H100 SXM's streaming multiprocessors
SMEM_LIMIT = 232448  # bytes of shared memory a block may take
# csrc/lane_packing.cu's constants
BM = 64  # rows per CTA: one wgmma M
THREADS = 160  # one consumer warpgroup and a producer warp
SLACK = 256  # alignment of the dynamic shared memory
ROW_BYTES = 32  # a k-step of one row of an operand: 16 bf16
SBO = 8 * ROW_BYTES  # stride byte offset: the next 8 rows
LBO = 16  # leading byte offset, unused with a swizzle
LAYOUT_SW32 = 3  # the descriptor's layout type: 32-byte swizzle
# the widths a CTA may take (the N of its wgmma) and the accumulator chains
# each is compiled with (FSE_K4_WIDTHS)
WIDTHS = {8: 8, 16: 8, 24: 6, 40: 4, 48: 4, 56: 4, 72: 3, 112: 2, 144: 2, 216: 1}
# column slices a case takes where more were faster than the whole N in one
# instruction (scripts/sweep_k4.py on an H100, PERF.md): the packed cases
# with half or a third of the rows, whose whole N leaves SMs idle or streams
# W; every other case takes its whole N. A table, not a rule: no rule of
# filling the card, keeping W resident or keeping N wide picks these. l5
# packed-2 is fastest split 3 ways (N 24, 216 CTAs) though split 2 (N 40,
# 144 CTAs) fills the card with W resident; l2/l6 packed-3 split 2 (96 CTAs)
# beats split 3 (144 CTAs) by 1.8x; l2/l6 and l7 packed-2 keep the whole N
# on 72 CTAs.
NCOL = {(3072, 648, 108): 2, (3072, 648, 36): 2, (4608, 864, 144): 3, (3072, 1296, 216): 2,
        (4608, 864, 72): 3, (3072, 1296, 108): 2}


CASES = tuple(
    case
    for cin, cout, label in [(36, 36, "l2/l6-class"), (72, 72, "l4-class"),
                             (36, 12, "l7-class"), (72, 36, "l5-class")]
    for case in ((label, "baseline", M_FULL, 9 * cin, cout),
                 (label, "packed-2", M_FULL // 2, 12 * cin, 2 * cout),
                 (label, "packed-3", M_FULL // 3, 18 * cin, 3 * cout)))


class TilePlan(NamedTuple):
    ks: int        # k-steps of 16 (k padded to kp = 16 ks)
    nc: int        # columns a CTA: the N of every wgmma
    ncol: int      # column slices (CTAs along N)
    rows: int      # 64-row tiles (CTAs along M)
    kc: int        # k-steps a chunk of the ring (all ks when resident)
    stages: int    # chunks the ring holds (1 when resident)
    resident: bool  # W is copied in once and stays
    smem: int      # dynamic shared memory bytes a CTA takes

    @property
    def ctas(self) -> int:
        return self.rows * self.ncol

    @property
    def kp(self) -> int:
        return 16 * self.ks


def _smem(ks: int, nc: int, kc: int, stages: int) -> int:
    """csrc/lane_packing.cu's smem_bytes: alignment slack, the A tile, the
    ring (all ks k-steps of W when it holds them), a full and an empty
    mbarrier a stage."""
    return SLACK + ks * BM * ROW_BYTES + min(stages * kc, ks) * nc * ROW_BYTES + 16 * stages


def plan_for(m: int, k: int, n: int, ncol: int = 1) -> TilePlan:
    """The plan with ``ncol`` column slices: W resident where the slice fits
    beside the A tile, else a ring of the most stages (4, 3, then 2) that
    leaves chunks of at least 2 k-steps and one k-step a chain."""
    ks = -(-k // 16)
    per_slice = -(-n // ncol)
    nc = -(-per_slice // 8) * 8
    if nc not in WIDTHS or (ncol - 1) * nc >= n:
        raise ValueError(f"no instantiation for {ncol} slices of n = {n} (width {nc})")
    rows = -(-m // BM)
    if _smem(ks, nc, ks, 1) <= SMEM_LIMIT:  # resident: one chunk of all ks k-steps
        return TilePlan(ks, nc, ncol, rows, ks, 1, True, _smem(ks, nc, ks, 1))
    room = SMEM_LIMIT - SLACK - ks * BM * ROW_BYTES
    for stages in (4, 3, 2):
        kc = (room - 16 * stages) // (stages * nc * ROW_BYTES)
        if kc >= max(2, WIDTHS[nc]):  # a chunk feeds every accumulator chain
            return TilePlan(ks, nc, ncol, rows, kc, stages, False, _smem(ks, nc, kc, stages))
    raise ValueError(f"k = {k} leaves no room for a ring of width {nc}")


def tile_plan(m: int, k: int, n: int) -> TilePlan:
    """The kernel's plan for an (m, k) x (k, n) case: the whole N in one
    instruction unless :data:`NCOL` says otherwise."""
    return plan_for(m, k, n, NCOL.get((m, k, n), 1))


def row_offset(r, h):
    """Byte offset of row ``r``'s 16-byte half ``h`` (k 8 h .. 8 h + 7 of
    the k-step) in a k-step block (csrc/lane_packing.cu's row_offset)."""
    return r * ROW_BYTES + ((h ^ ((r >> 2) & 1)) << 4)


def descriptor(addr: int) -> int:
    """The wgmma matrix descriptor of a K-major block at shared address
    ``addr`` (csrc/lane_packing.cu's descriptor)."""
    return ((addr & 0x3FFFF) >> 4) | ((LBO >> 4) << 16) | ((SBO >> 4) << 32) | (LAYOUT_SW32 << 62)


def prepare_weight(w: torch.Tensor, plan: TilePlan) -> torch.Tensor:
    """(k, n) bf16 -> the kernel's shared-memory image of W, flat
    [column slice][k-step][nc rows][16 k], each k-step block laid out by
    :func:`row_offset`, zero-padded to kp rows and ncol * nc columns, in
    ``w``'s dtype and on its device."""
    k, n = w.shape
    wp = F.pad(w, (0, plan.ncol * plan.nc - n, 0, plan.kp - k))
    # x[c, s, r, h, e] = wp[16 s + 8 h + e, c nc + r]
    x = wp.reshape(plan.ks, 2, 8, plan.ncol, plan.nc).permute(3, 0, 4, 1, 2)
    r = torch.arange(plan.nc, device=w.device)
    # half h of row r sits at position h ^ ((r >> 2) & 1)
    flip = ((r >> 2) & 1).bool()[None, None, :, None, None]
    return torch.where(flip, x.flip(3), x).contiguous().reshape(-1)


_PREP: dict = {}


def _prepared(w: torch.Tensor, plan: TilePlan) -> torch.Tensor:
    """:func:`prepare_weight`, cached for the last weight (keyed on its
    identity and version counter, which an in-place update bumps)."""
    key = (id(w), w._version, plan)
    hit = _PREP.get(key)
    if hit is None:
        _PREP.clear()
        hit = (w, prepare_weight(w, plan))  # keeps w alive, so its id stays unique
        _PREP[key] = hit
    return hit[1]


INFO_KEYS = ("registers", "local_bytes", "static_smem", "dynamic_smem", "threads", "chains")


def kernel_info(plan: TilePlan, device=0) -> dict:
    """The compiled instantiation of ``plan.nc``'s registers a thread, local
    memory a thread (its spills), static shared memory, the dynamic shared
    memory of ``plan``'s ring, threads a CTA and accumulator chains
    (``fse_lane_packing_info``)."""
    from .build import load_library

    out = (ctypes.c_int * len(INFO_KEYS))()
    rc = load_library().fse_lane_packing_info(out, plan.nc, plan.ks, plan.kc, plan.stages,
                                   torch.device(device).index or 0)
    if rc != 0:
        raise RuntimeError(f"fse_lane_packing_info failed: CUDA error {rc}")
    return dict(zip(INFO_KEYS, out))


def lane_packing_mm_plain(a: torch.Tensor, w: torch.Tensor, grid: int,
                          reps: int = REPS) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4's function in eager torch, on any device: ``(o, acc)``."""
    ab = a.to(torch.bfloat16).float()
    wf = w.to(torch.bfloat16).float()
    acc = torch.zeros(a.shape[0], w.shape[1], dtype=torch.float32, device=a.device)
    for _ in range(reps * grid):
        acc = (ab @ wf) * 1e-4 + acc * 0.5
    o = a.float() * 0.999 + 1e-7 * acc.sum(dim=1, keepdim=True)
    return o, acc


def _check(a: torch.Tensor, w: torch.Tensor, grid: int, reps: int) -> None:
    if a.dtype != torch.float32 or a.dim() != 2 or not a.is_contiguous():
        raise ValueError(f"lane_packing_mm takes a contiguous (m, k) fp32 a, got {a.dtype} "
                         f"{tuple(a.shape)}")
    if w.dtype != torch.bfloat16 or w.dim() != 2 or w.shape[0] != a.shape[1]:
        raise ValueError(f"lane_packing_mm takes a (k, n) bf16 w with k = {a.shape[1]}, got "
                         f"{w.dtype} {tuple(w.shape)}")
    if w.device != a.device:
        raise ValueError("a and w must be on one device")
    if min(a.shape) < 1 or w.shape[1] < 1 or grid < 1 or reps < 1:
        raise ValueError(f"empty shape or count: {tuple(a.shape)} {tuple(w.shape)} {grid} {reps}")


def launch(a: torch.Tensor, image: torch.Tensor, n: int, plan: TilePlan,
           products: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of the kernel (and of its row-sum kernel) on ``a``'s
    current stream with W's shared-memory ``image`` (:func:`prepare_weight`)
    of n columns, laid out for ``plan``: ``(o, acc)``; uncounted (a sweep of
    plans calls it)."""
    from .build import load_library

    m, k = a.shape
    acc = torch.empty(m, n, dtype=torch.float32, device=a.device)
    o = torch.empty_like(a)
    rc = load_library().fse_lane_packing(
        a.data_ptr(), image.data_ptr(), acc.data_ptr(), o.data_ptr(), m, k, n, plan.ks,
        plan.nc, plan.ncol, plan.kc, plan.stages, int(plan.resident), products,
        a.device.index, torch.cuda.current_stream(a.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"lane_packing_mm kernel launch failed: CUDA error {rc}")
    return o, acc


def lane_packing_mm(a: torch.Tensor, w: torch.Tensor, grid: int,
                    reps: int = REPS) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4's wrapper: ``(o, acc)`` for ``a`` (m, k) fp32 and ``w`` (k, n) bf16,
    with :func:`tile_plan`'s plan.

    A CUDA tensor launches the kernel on the current stream (the chain, then
    the row sums and ``o``; no synchronise, no allocation inside the kernel);
    a CPU tensor takes the plain version.
    """
    _check(a, w, grid, reps)
    if a.device.type == "cpu":
        return lane_packing_mm_plain(a, w, grid, reps)
    if a.device.type != "cuda":
        raise ValueError(f"lane_packing_mm runs on cuda or cpu, got {a.device}")
    plan = tile_plan(a.shape[0], a.shape[1], w.shape[1])
    o, acc = launch(a, _prepared(w, plan), w.shape[1], plan, reps * grid)
    lane_packing_mm.launches += 1
    return o, acc


lane_packing_mm.launches = 0
