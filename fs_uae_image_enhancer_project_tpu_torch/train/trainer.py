"""The training loop.

Port of ``fs_uae_image_enhancer_project_tpu/train/trainer.py``: the epoch
loop with gradient accumulation, validation, CSV-based resume, best and
interval checkpoints, early stopping by patience, per-epoch sample renders
and per-epoch metrics (JSONL).

- Training differentiates the eager forward (``models.train_apply``);
  validation runs ``model.apply`` in the compute dtype under
  ``torch.no_grad()``, so on a card the lightweight pix_shuffle validates
  through the fused-stack kernel K1 (each epoch's metrics line counts its
  validation's launches, ``val_k1_launches``). Sample renders run in fp32
  (eager).
- With a ``mesh`` (``parallel.mesh.make_mesh``, one process a rank) the
  state is replicated from rank 0, each rank loads only its dp share of
  every batch and keeps its block of rows over sp for training (whole frames
  for validation), the train step all-reduces the gradients and
  the loss, and the validation loss is all-reduced too: every rank takes the
  same decisions and leaves with the same parameters. Rank 0 alone writes
  the CSV, the metrics, the checkpoints and the renders.
- Checkpoints are the JAX package's: orbax directories (``orbax_writer``)
  of ``{step, params, buffers, opt_state}`` at its path names, Adam's and
  the schedule's state as optax's tree for ``make_optimizer``'s chain
  (``parallel.train_step.optax_state``). So the JAX package's
  ``load_params`` and ``load_checkpoint`` restore a run trained here, and
  its trainer resumes one from the CSV. The CSV stays the resume source for
  epochs, patience and the learning rate.
- Either package's orbax checkpoints are read (``orbax_reader``): so a run
  the JAX trainer began resumes here as it would there, with its weights
  and buffers, a fresh optimizer and the CSV's learning rate, and
  ``load_params`` serves export and evaluation. A ``state.pt`` that earlier
  runs of the port wrote with ``torch.save`` is still read; nothing writes
  one any more.
"""
from __future__ import annotations

import csv
import dataclasses
import gc
import glob
import json
import os
import time
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..data.dataset import SRDataset, batch_transform, device_prefetch
from ..interop import params_from_jax
from ..losses.perceptual import build_criterion
from ..models import ModelDef, train_apply
from ..ops.cuda import fused_stack as k1
from ..parallel.mesh import all_reduce_
from ..parallel.train_step import (
    TrainState,
    init_train_state,
    leaves,
    make_optimizer,
    make_train_step,
    merge_bn_buffers,
    optax_state,
    restore_optax,
)
from .orbax_reader import EMPTY_BUFFERS, is_orbax_checkpoint, read_orbax
from .orbax_writer import committed, write_orbax

CSV_HEADER = [
    "Epoch", "Train Loss", "Validation Loss", "EpochsNoImprove",
    "LearningRate", "Checkpoint Path",
]
# the torch.save file of a checkpoint directory that earlier runs of the
# port wrote: read, never written
LEGACY_CHECKPOINT_FILE = "state.pt"


def save_training_stats(csv_file: str, epoch: int, train_loss: float, val_loss: float,
                        epochs_no_improve: int, learning_rate: float,
                        checkpoint_path: str) -> None:
    """Append one row (the reference trainer's columns)."""
    exists = os.path.isfile(csv_file)
    with open(csv_file, "a", newline="") as f:
        w = csv.writer(f)
        if not exists:
            w.writerow(CSV_HEADER)
        w.writerow([epoch, train_loss, val_loss, epochs_no_improve, learning_rate,
                    checkpoint_path])


def load_last_epoch_and_checkpoint(
    lr: float, csv_file: str
) -> Tuple[int, float, int, int, float, Optional[str]]:
    """(last_epoch, best_val, best_epoch, no_improve, lr, ckpt_path) from the
    stats CSV."""
    if not os.path.isfile(csv_file):
        return 0, float("inf"), 0, 0, lr, None
    with open(csv_file) as f:
        rows = list(csv.reader(f))[1:]
    if not rows:
        return 0, float("inf"), 0, 0, lr, None
    best_val, best_epoch = float("inf"), 0
    for row in rows:
        v, e = float(row[2]), int(row[0])
        if v < best_val:
            best_val, best_epoch = v, e
    last = rows[-1]
    return int(last[0]), best_val, best_epoch, int(last[3]), float(last[4]), last[5]


# ---------------------------------------------------------------------------
# checkpoint I/O
# ---------------------------------------------------------------------------

def _host(tree):
    """A tree of tensors as numpy arrays on the host, each in its own dtype
    (the bytes unchanged; an empty dict stays one)."""
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()


def save_checkpoint(path: str, state: TrainState) -> None:
    """Write ``state`` to the directory ``path`` as the JAX package's
    ``save_checkpoint`` does: an orbax checkpoint of ``{step (int32),
    params, buffers (the __empty__ sentinel without batchnorm), opt_state
    (``parallel.train_step.optax_state``)}``, each leaf copied to the host
    bit for bit. A checkpoint already at ``path`` is replaced once the new
    one is whole."""
    write_orbax(path, {
        "step": np.int32(state.step), "params": _host(state.params),
        "buffers": (_host(state.buffers) if state.buffers
                    else {EMPTY_BUFFERS: np.zeros((1,), np.float32)}),
        "opt_state": optax_state(state)})


def _read(path: str, opt_state: bool = False) -> dict:
    """The checkpoint in directory ``path`` as CPU tensors: an orbax
    checkpoint of either package (step, params, buffers, and optax's
    ``opt_state`` if asked), or an earlier port run's ``torch.save`` file
    (step, params, buffers, optimizer, scheduler). A checkpoint whose
    rewrite died between its renames is read where it was set aside
    (``orbax_writer.committed``)."""
    path = committed(path)
    f = os.path.join(path, LEGACY_CHECKPOINT_FILE)
    if os.path.isfile(f):
        return torch.load(f, map_location="cpu", weights_only=True)
    if is_orbax_checkpoint(path):
        subtrees = ("step", "params", "buffers") + (("opt_state",) if opt_state else ())
        saved = read_orbax(path, subtrees)
        out = {"step": int(saved["step"]),
               "params": params_from_jax(saved["params"], device="cpu"),
               "buffers": params_from_jax(saved["buffers"], device="cpu")}
        if opt_state:
            out["opt_state"] = saved["opt_state"]
        return out
    raise FileNotFoundError(f"no orbax checkpoint and no {LEGACY_CHECKPOINT_FILE} at {path}")


def _copy_into(dst, src):
    if isinstance(dst, dict):
        for k in dst:
            _copy_into(dst[k], src[k])
        return
    with torch.no_grad():
        dst.copy_(src)


def load_params(path: str, params_template):
    """The parameters of a checkpoint (the port's, or the JAX package's
    orbax one), merged with its batchnorm buffers, on the template's
    devices and dtypes (for export and inference), as the JAX package's
    ``load_params`` returns them."""
    saved = _read(path)
    params = merge_bn_buffers(saved["params"], saved["buffers"])

    def place(t, v):
        if isinstance(t, dict):
            return {k: place(t[k], v[k]) for k in t}
        return v.to(t.device, t.dtype)

    return place(params_template, params)


def load_checkpoint(path: str, template: TrainState) -> TrainState:
    """Restore a checkpoint into ``template`` (from ``init_train_state``):
    parameters and buffers are copied in place, the step is the
    checkpoint's, and the optimizer and scheduler take its state: optax's
    ``opt_state`` of an orbax checkpoint (of either package's
    ``make_optimizer`` chain), or an earlier ``state.pt``'s state dicts."""
    saved = _read(path, opt_state=True)
    _copy_into(template.params, saved["params"])
    _copy_into(template.buffers, saved["buffers"])
    if "optimizer" in saved:
        template.optimizer.load_state_dict(saved["optimizer"])
        template.scheduler.load_state_dict(saved["scheduler"])
    else:
        restore_optax(template, saved["opt_state"])
    return template._replace(step=saved["step"])


# ---------------------------------------------------------------------------
# sample-frame rendering
# ---------------------------------------------------------------------------

def make_render_fn(model_apply: Callable, linear_io: bool = True):
    """The sample-render forward, fp32, no gradient: ``fwd(params, x)`` on an
    NHWC sRGB [0, 1] batch -> sRGB [0, 1]."""

    @torch.no_grad()
    def fwd(p, x):
        if linear_io:
            x = x**2.2
        y = model_apply(p, x)
        if linear_io:
            y = torch.clamp(y, min=0.0) ** (1 / 2.2)
        return torch.clamp(y, 0.0, 1.0)

    return fwd


def inference_on_directory(model_apply: Callable, params, input_dir: str, output_dir: str, *,
                           linear_io: bool = True, render_fn: Optional[Callable] = None,
                           device=None) -> float:
    """Enhance every PNG in ``input_dir`` into ``output_dir`` on ``device``
    (default ``cuda``); returns the mean seconds an image."""
    from PIL import Image

    dev = resolve_device(device)
    os.makedirs(output_dir, exist_ok=True)
    paths = sorted(glob.glob(os.path.join(input_dir, "*.png")))
    if not paths:
        return 0.0
    fwd = render_fn if render_fn is not None else make_render_fn(model_apply, linear_io)
    t0 = time.time()
    for path in paths:
        img = np.asarray(Image.open(path).convert("RGB"), np.float32) / 255.0
        out = fwd(params, torch.from_numpy(img)[None].to(dev))[0].cpu().numpy()
        Image.fromarray((out * 255.0).astype(np.uint8)).save(
            os.path.join(output_dir, os.path.basename(path)))
    return (time.time() - t0) / len(paths)


def dump_internal_activations(model: ModelDef, params, samples_dir: str, out_dir: str,
                              epoch: int, device=None) -> None:
    """Per-layer activation images of the first sample frame (pix_shuffle
    only): each tensor channel-averaged, min-max normalized and saved as
    ``epoch_<n>_basic_<tag>.png``."""
    from PIL import Image

    if model.name != "pix_shuffle":
        return
    from ..models import pix_shuffle as ps

    paths = sorted(glob.glob(os.path.join(samples_dir, "*.png")))
    if not paths:
        return
    img = np.asarray(Image.open(paths[0]).convert("RGB"), np.float32) / 255.0
    x = torch.from_numpy(img**2.2)[None].to(resolve_device(device))
    with torch.no_grad():
        _y, captured = ps.apply_with_intermediates(params, x, model.config)
    for tag, t in captured.items():
        a = t[0].float().cpu().numpy().mean(axis=-1)  # channel average
        a = (a - a.min()) / (a.max() - a.min() + 1e-8)
        Image.fromarray((a * 255).astype(np.uint8), mode="L").save(
            os.path.join(out_dir, f"epoch_{epoch}_basic_{tag}.png"))


# ---------------------------------------------------------------------------
# Trainer
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TrainerConfig:
    num_epochs: int = 10
    lr: float = 1e-3
    weight_decay: float = 1e-5
    lr_decay_rate: float = 0.955  # per-epoch decay
    batch_size: int = 1
    accumulation_steps: int = 16
    checkpoint_interval: int = 5
    early_stopping_patience: int = 10
    checkpoint_dir: str = "."
    samples_dir: Optional[str] = None  # per-epoch rendering source
    inference_always: bool = False
    dump_internals: bool = False  # save per-layer activation images
    compute_dtype: str = "bfloat16"
    mesh: Optional[object] = None  # parallel.mesh.Mesh: this process is one rank
    verbose: int = 1
    # wait for the card every K optimizer steps, never fetch a loss a step:
    # the epoch's losses are stacked on the device and fetched once
    loss_sync_steps: int = 8
    device: Optional[str] = None  # None means cuda


class Trainer:
    def __init__(self, model: ModelDef, cfg: TrainerConfig, vgg_params=None):
        self.model = model
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        self.criterion = build_criterion(model.loss, vgg_params, device=self.device)
        self.has_bn = model.name in ("conv3", "conv5")
        self.stats_file = os.path.join(cfg.checkpoint_dir, f"training_stats_{model.name}.csv")
        self.metrics_file = os.path.join(cfg.checkpoint_dir, f"metrics_{model.name}.jsonl")
        self._render_fn = make_render_fn(model.apply, model.linear_io)

    @property
    def lead(self) -> bool:
        """Whether this process writes: always on one card, rank 0 on a mesh."""
        return self.cfg.mesh is None or self.cfg.mesh.rank == 0

    def _log(self, msg: str) -> None:
        if self.cfg.verbose and self.lead:
            print(msg, flush=True)

    def _log_metrics(self, **kv) -> None:
        if not self.lead:
            return
        os.makedirs(self.cfg.checkpoint_dir, exist_ok=True)
        with open(self.metrics_file, "a") as f:
            f.write(json.dumps(kv) + "\n")

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def steps_per_epoch(self, train_ds: SRDataset) -> int:
        """Optimizer steps an epoch (a ceiling: the tail flush is a step)."""
        return max(-(-len(train_ds) // self.cfg.accumulation_steps), 1)

    def optimizer(self, lr: float, train_ds: SRDataset):
        """The optimizer :meth:`train` builds, at learning rate ``lr``."""
        cfg = self.cfg
        return make_optimizer(lr=lr, weight_decay=cfg.weight_decay,
                              lr_decay_rate=cfg.lr_decay_rate,
                              steps_per_epoch=self.steps_per_epoch(train_ds))

    def train(self, train_ds: SRDataset, val_ds: Optional[SRDataset], *,
              state: Optional[TrainState] = None) -> Tuple[float, int, float]:
        """Train from the CSV's last epoch to ``num_epochs``; returns
        ``(best_val, best_epoch, avg_inference_seconds)``. ``state`` (from
        ``init_train_state``) replaces the fresh initialization."""
        cfg = self.cfg
        m = self.model
        dev = self.device
        mesh = cfg.mesh
        os.makedirs(cfg.checkpoint_dir, exist_ok=True)
        (start_epoch, best_val, best_epoch, no_improve, lr0, ckpt_path) = (
            load_last_epoch_and_checkpoint(cfg.lr, self.stats_file))
        self._log(f"Starting from epoch {start_epoch + 1}, best val {best_val:.4f}, "
                  f"patience used {no_improve}, lr {lr0}")
        if state is None:
            params = m.init(torch.Generator().manual_seed(0), device=dev)
            if ckpt_path and not os.path.isdir(committed(ckpt_path)):
                # the CSV says this run resumes from that checkpoint: going on
                # from fresh weights against the CSV's best would waste the run
                raise FileNotFoundError(
                    f"resume checkpoint from {self.stats_file} not found: {ckpt_path!r} "
                    "(relative paths resolve against the current working directory)")
            if ckpt_path:
                # weights from the checkpoint, the learning rate from the CSV,
                # a FRESH optimizer: restoring the schedule's count too would
                # apply the decay already in lr0 twice
                params = load_params(ckpt_path, params)
                self._log(f"Loaded checkpoint weights: {ckpt_path}")
            # resume as the reference does: the optimizer restarts from the
            # CSV's last learning rate and the decay continues from there
            state = init_train_state(params, self.optimizer(lr0, train_ds),
                                     has_batchnorm=self.has_bn)

        sharded = mesh is not None and mesh.world_group is not None
        train_batches = eval_batches = iter
        if sharded:
            import torch.distributed as dist

            # rank 0's state on every rank, in place: the optimizer holds the leaves
            with torch.no_grad():
                for t in leaves(state.params) + leaves(state.buffers):
                    dist.broadcast(t, src=0)

            # each rank loads only its dp share of every host batch; training
            # keeps its sp block of rows (stacked, the blocks are
            # accum_batch_sharding's block of the accumulation batch) and
            # validation whole frames
            def eval_batches(ds):
                return ds.batches(mesh.dp_index, mesh.dp)

            def train_batches(ds):
                for b in eval_batches(ds):
                    rows = b[0].shape[1] // mesh.sp
                    yield tuple(a[:, mesh.sp_index * rows:(mesh.sp_index + 1) * rows]
                                for a in b)

        compute_dtype = getattr(torch, cfg.compute_dtype)
        # uint8 batches become fp32 on the device; fp32 batches pass
        to_float = batch_transform(m.linear_io)
        train_step = make_train_step(train_apply(m), self.criterion,
                                     has_batchnorm=self.has_bn, compute_dtype=compute_dtype,
                                     mesh=mesh, input_transform=to_float)

        @torch.no_grad()
        def eval_loss(params, buffers, lr_b, hr_b):
            full = merge_bn_buffers(params, buffers)
            x = to_float(lr_b).to(compute_dtype)
            y = m.apply(full, x)  # inference mode: running BN stats; K1 on a card
            loss = self.criterion(y.float(), to_float(hr_b))
            if sharded:
                # the sp ranks of a dp share hold the same loss: the mean over
                # the mesh is the dp shares' mean, the global batch's
                loss = all_reduce_(loss.clone(), mesh.world_group) / mesh.size
            return loss

        avg_inference_time = 0.0
        sync_every = max(cfg.loss_sync_steps, 1)
        for epoch in range(start_epoch + 1, cfg.num_epochs + 1):
            t_epoch = time.time()
            # ---- train ----
            losses: List[torch.Tensor] = []
            accum_lr, accum_hr = [], []
            for lr_b, hr_b in device_prefetch(train_batches(train_ds), device=dev):
                accum_lr.append(lr_b)
                accum_hr.append(hr_b)
                if len(accum_lr) < cfg.accumulation_steps:
                    continue
                state, loss = train_step(state, torch.stack(accum_lr), torch.stack(accum_hr))
                accum_lr, accum_hr = [], []
                losses.append(loss)
                if len(losses) % sync_every == 0:
                    self._sync()
            if accum_lr:  # the tail flush
                state, loss = train_step(state, torch.stack(accum_lr), torch.stack(accum_hr))
                losses.append(loss)
            # one device->host transfer for the epoch
            train_loss = (float(np.mean(torch.stack(losses).cpu().numpy()))
                          if losses else float("nan"))

            # ---- validate ----
            val_losses: List[torch.Tensor] = []
            k1_before = k1.fused_stack.launches
            if val_ds is not None and val_ds.pool:
                for lr_b, hr_b in device_prefetch(eval_batches(val_ds), device=dev):
                    val_losses.append(eval_loss(state.params, state.buffers, lr_b, hr_b))
                    if len(val_losses) % sync_every == 0:
                        self._sync()
            val_loss = (float(np.mean(torch.stack(val_losses).cpu().numpy()))
                        if val_losses else train_loss)

            current_lr = lr0 * (cfg.lr_decay_rate ** (epoch - start_epoch))
            new_best = val_loss < best_val
            apply_inference = cfg.inference_always or new_best
            if new_best:
                best_val, best_epoch, no_improve = val_loss, epoch, 0
                ckpt_path = os.path.join(cfg.checkpoint_dir, f"checkpoint_best_{m.name}")
                if self.lead:
                    save_checkpoint(ckpt_path, state)
                self._log("New best model saved.")
            else:
                no_improve += 1

            if self.lead and (epoch % cfg.checkpoint_interval == 0 or new_best
                              or no_improve > cfg.early_stopping_patience
                              or epoch == cfg.num_epochs):
                epoch_ckpt = os.path.join(cfg.checkpoint_dir, f"checkpoint_epoch_{epoch}_{m.name}")
                save_checkpoint(epoch_ckpt, state)
                save_training_stats(self.stats_file, epoch, train_loss, val_loss, no_improve,
                                    current_lr, epoch_ckpt)

            self._log_metrics(epoch=epoch, train_loss=train_loss, val_loss=val_loss,
                              lr=current_lr, seconds=round(time.time() - t_epoch, 2),
                              val_k1_launches=k1.fused_stack.launches - k1_before)
            self._log(f"Epoch [{epoch}/{cfg.num_epochs}] Train {train_loss:.4f} "
                      f"Val {val_loss:.4f} Patience "
                      f"{cfg.early_stopping_patience - no_improve} LR {current_lr:.6f}")

            if no_improve > cfg.early_stopping_patience:
                self._log("Early stopping triggered.")
                break

            if apply_inference and cfg.samples_dir and self.lead:
                full_params = merge_bn_buffers(state.params, state.buffers)
                avg_inference_time = inference_on_directory(
                    m.apply, full_params, cfg.samples_dir,
                    os.path.join(cfg.checkpoint_dir, "predicted"),
                    linear_io=m.linear_io, render_fn=self._render_fn, device=dev)
                self._log(f"Rendered samples; {avg_inference_time:.4f}s per image")
                if cfg.dump_internals:
                    dump_internal_activations(m, full_params, cfg.samples_dir,
                                              cfg.checkpoint_dir, epoch, device=dev)
            gc.collect()

        return best_val, best_epoch, avg_inference_time
