"""The spatial split: the port's stand-in for XLA's halo exchange under sp.

Under the JAX package's ('dp', 'sp') mesh the height axis is sharded over sp,
and XLA inserts halo exchanges between neighbouring shards before each
convolution. The port splits once, at the model's input: the sp rank with
index i owns rows ``[i h / sp, (i + 1) h / sp)`` of an h-row frame, runs the
whole model on those rows plus ``halo`` rows on each side, and crops the halo
off the output. The halo is the model's receptive radius, so each row it
keeps sees every input row the unsharded forward lets it see: the result is
the unsharded forward's. At the frame's top and bottom edges there is no
halo, and the model's zero padding is what it is in the unsharded forward.

- :func:`model_halo` works the radius out from a model's config: one row a
  layer for each 3x3 conv on the longest path (the 1x1 skip projections add
  none), times the pixel-unshuffle factor where the convs run at reduced
  resolution; slab edges then fall on multiples of that factor. The residual
  U-Net has no finite radius (its triplet attention pools whole rows and
  columns) and is refused.
- :func:`apply_split` runs every slab in turn in one process (no process
  group): the split's own result on one device.
- :func:`gather_rows` all-gathers the slabs' output rows over the mesh's sp
  group; its backward returns this rank's rows of the incoming gradient and
  communicates nothing, because every sp rank computes the same loss on the
  same gathered frame (``parallel/train_step.py``).

A BatchNorm model in training takes its statistics over each slab's owned
rows only (:func:`apply_slab` passes them), all-reduced over the mesh, so the
halo rows do not count twice.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import torch
import torch.distributed as dist

from ..models.configs import Conv6Config, ConvStackConfig, PixShuffleConfig


class Halo(NamedTuple):
    rows: int  # input rows on each side of a slab: the receptive radius
    align: int  # slab edges fall on multiples of this many rows


def model_halo(model) -> Halo:
    """The receptive radius of a ``models.get_model`` model, from its config."""
    cfg = model.config
    if isinstance(cfg, PixShuffleConfig):
        f = cfg.shuffle_factor
        return Halo(sum(l.kernel_size // 2 for l in cfg.layers) * f, f)
    if isinstance(cfg, Conv6Config):
        return Halo(sum(l.kernel_size // 2 for l in cfg.layers), 1)
    if isinstance(cfg, ConvStackConfig):
        return Halo(len(cfg.channels) * (cfg.kernel_size // 2), 1)
    raise ValueError(
        f"no spatial split for {model.name}: its receptive field is not a finite "
        "number of rows (the residual U-Net's triplet attention pools whole rows)")


def slab(h: int, sp: int, index: int, halo: Halo) -> Tuple[int, int, int, int]:
    """``(lo, hi, a, b)``: slab ``index`` of ``sp`` owns rows [lo, hi) of an
    ``h``-row frame and runs the model on rows [a, b)."""
    if h % (sp * halo.align):
        raise ValueError(
            f"height {h} does not split into {sp} slabs of a multiple of {halo.align} rows")
    step = h // sp
    lo, hi = index * step, (index + 1) * step
    return lo, hi, max(0, lo - halo.rows), min(h, hi + halo.rows)


def apply_slab(model_apply: Callable, params, x: torch.Tensor, *, sp: int, index: int,
               halo: Halo, **train_kw):
    """Slab ``index``'s output rows of the NHWC forward ``model_apply(params, x)``.

    With ``train_kw`` (a BatchNorm model in training: ``train=True`` and its
    ``bn_group``) the model also gets ``bn_rows``, the slab's owned rows,
    and returns ``(y, stats)``: this returns ``(rows of y, stats)``."""
    lo, hi, a, b = slab(x.shape[1], sp, index, halo)
    if not train_kw:
        return model_apply(params, x[:, a:b])[:, lo - a:hi - a]
    y, stats = model_apply(params, x[:, a:b], bn_rows=(lo - a, hi - a), **train_kw)
    return y[:, lo - a:hi - a], stats


def apply_split(model_apply: Callable, params, x: torch.Tensor, *, sp: int,
                halo: Halo) -> torch.Tensor:
    """Every slab in turn in this process, concatenated over rows."""
    return torch.cat([apply_slab(model_apply, params, x, sp=sp, index=i, halo=halo)
                      for i in range(sp)], dim=1)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, group, index, size):
        parts = [torch.empty_like(y) for _ in range(size)]
        dist.all_gather(parts, y.contiguous(), group=group)
        ctx.index, ctx.rows = index, y.shape[1]
        return torch.cat(parts, dim=1)

    @staticmethod
    def backward(ctx, grad):
        lo = ctx.index * ctx.rows
        return grad[:, lo:lo + ctx.rows], None, None, None


def gather_rows(y: torch.Tensor, mesh) -> torch.Tensor:
    """The sp group's slabs of NHWC ``y`` (equal row counts), concatenated
    over rows in slab order, on every rank of the group; differentiable
    (see the module's docstring). ``y`` itself without an sp group."""
    if mesh.sp_group is None:
        return y
    return _GatherRows.apply(y, mesh.sp_group, mesh.sp_index, mesh.sp)
