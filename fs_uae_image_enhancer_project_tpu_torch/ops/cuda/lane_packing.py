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
- :func:`tile_plan` picks the kernel's column tiling for a shape.
- :data:`CASES` are the bench's 12 GEMM shapes, (layer class, variant, m,
  k, n): per class the baseline (m, 9 cin) x (9 cin, cout), packed-2
  (m/2, 12 cin) x (12 cin, 2 cout) and packed-3 (m/3, 18 cin) x
  (18 cin, 3 cout).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from .fused_stack import fragments

# m = STRIP(24) * wp(384): one fused-stack strip's matmul rows on the TPU
M_FULL = 24 * 384
REPS = 8  # products per grid step
SMS = 132  # the H100 SXM's streaming multiprocessors
SMEM_LIMIT = 232448  # bytes of shared memory a block may take
BM = 64  # rows per CTA (csrc/lane_packing.cu)


CASES = tuple(
    case
    for cin, cout, label in [(36, 36, "l2/l6-class"), (72, 72, "l4-class"),
                             (36, 12, "l7-class"), (72, 36, "l5-class")]
    for case in ((label, "baseline", M_FULL, 9 * cin, cout),
                 (label, "packed-2", M_FULL // 2, 12 * cin, 2 * cout),
                 (label, "packed-3", M_FULL // 3, 18 * cin, 3 * cout)))


class TilePlan(NamedTuple):
    kp: int      # k padded to a multiple of 16
    ntw: int     # 8-column mma tiles per CTA
    ncol: int    # column slices (CTAs along N)
    ctas: int    # CTAs in the grid
    smem: int    # shared memory bytes a CTA takes


def _smem(kp: int, ntw: int) -> int:
    """Shared memory of a CTA (csrc/lane_packing.cu's smem_bytes): the A tile
    in bf16 with rows of kp + 8, and NTW column tiles of B fragments."""
    return BM * (kp + 8) * 2 + (kp // 16) * ntw * 32 * 8


def tile_plan(m: int, k: int, n: int) -> TilePlan:
    """The column tiling for an (m, k) x (k, n) case: the fewest column
    slices that give at least one CTA per SM and fit the CTA's A tile and
    W slice in shared memory. The packed variants have half or a third of the
    baseline's rows, so they get more slices instead of an idle card."""
    kp = -(-k // 16) * 16
    nt = -(-n // 8)
    rows = -(-m // BM)
    for ncol in range(max(1, -(-SMS // rows)), nt + 1):
        ntw = -(-nt // ncol)
        if ntw <= 9 and _smem(kp, ntw) <= SMEM_LIMIT:
            return TilePlan(kp, ntw, ncol, rows * ncol, _smem(kp, ntw))
    for ntw in range(min(nt, 9), 0, -1):  # fewer rows than SMs at one tile a slice
        if _smem(kp, ntw) <= SMEM_LIMIT:
            ncol = -(-nt // ntw)
            return TilePlan(kp, ntw, ncol, rows * ncol, _smem(kp, ntw))
    raise ValueError(f"k = {k} does not fit the kernel's shared memory")


def prepare_weight(w: torch.Tensor, plan: TilePlan) -> torch.Tensor:
    """(k, n) bf16 -> B fragments over (kp, ncol * ntw * 8), zero-padded, on
    ``w``'s device."""
    k, n = w.shape
    cols = plan.ncol * plan.ntw * 8
    return fragments(F.pad(w.float(), (0, cols - n, 0, plan.kp - k)))


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


def lane_packing_mm(a: torch.Tensor, w: torch.Tensor, grid: int,
                    reps: int = REPS) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4's wrapper: ``(o, acc)`` for ``a`` (m, k) fp32 and ``w`` (k, n) bf16.

    A CUDA tensor launches the kernel on the current stream (the chain, then
    the row sums and ``o``; no synchronise, no allocation inside the kernel);
    a CPU tensor takes the plain version.
    """
    _check(a, w, grid, reps)
    if a.device.type == "cpu":
        return lane_packing_mm_plain(a, w, grid, reps)
    if a.device.type != "cuda":
        raise ValueError(f"lane_packing_mm runs on cuda or cpu, got {a.device}")
    from .build import load_library

    m, k = a.shape
    n = w.shape[1]
    plan = tile_plan(m, k, n)
    wf = _prepared(w, plan)
    acc = torch.empty(m, n, dtype=torch.float32, device=a.device)
    o = torch.empty_like(a)
    rc = load_library().fse_lane_packing(
        a.data_ptr(), wf.data_ptr(), acc.data_ptr(), o.data_ptr(), m, k, plan.kp, n,
        plan.ncol * plan.ntw, plan.ntw, reps * grid, a.device.index,
        torch.cuda.current_stream(a.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"lane_packing_mm kernel launch failed: CUDA error {rc}")
    lane_packing_mm.launches += 1
    return o, acc


lane_packing_mm.launches = 0
