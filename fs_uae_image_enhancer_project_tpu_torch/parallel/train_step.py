"""The training step, on one card or over a (dp, sp) mesh of processes.

Port of ``fs_uae_image_enhancer_project_tpu/parallel/train_step.py``: forward
in the compute dtype, the loss in fp32, backward, gradient accumulation over
micro-batches and the optimizer step.

- The step loops over the micro-batch axis: ``backward`` adds each
  micro-batch's gradient into ``.grad``, and the sum is divided by the number
  of micro-batches, as the JAX package's ``lax.scan`` does. BatchNorm running
  stats thread through the micro-batches in order.
- Mixed precision is the JAX package's, not autocast's: the input is cast to
  the compute dtype (bf16 by default) and each conv casts its fp32 weight to
  the input's dtype, so activations are bf16, parameters and gradients fp32,
  and the criterion runs on fp32 tensors. Forward and backward run with
  TF32 off (:func:`ops.conv.no_tf32`), so fp32 convolutions (VGG's) are fp32.
- The optimizer is ``torch.optim.Adam`` with ``weight_decay`` (an L2 term
  folded into the gradient before the moments: optax's
  ``add_decayed_weights`` before ``scale_by_adam``) and a staircase
  exponential decay of the learning rate every ``steps_per_epoch`` steps.
- Batchnorm models keep their running stats in the state's ``buffers``,
  outside the optimizer.

Under a mesh (``parallel.mesh.make_mesh``) each rank takes its block of the
global batch (``accum_batch_sharding``: batch over dp, height over sp) and
the step gives the JAX step's result on the global batch, on every rank:

- dp: after the accumulation loop the gradients are all-reduced (a sum over
  every rank of the mesh) and divided by dp. Each rank's loss is a mean over
  its equal shard, so that is the gradient of the global mean. A BatchNorm
  model with sp = 1 takes its batch statistics over the dp group
  (``ops.conv.batchnorm_train``), as GSPMD makes JAX's global.
- sp: the sp group all-gathers its row blocks of both batches (the input
  then stands for every slab's halo), each rank runs the model on its slab
  plus halo (``parallel/spatial.py``, the halo from ``spatial.model_halo``),
  and the output rows are all-gathered back to whole frames. The loss (VGG
  included) runs unsharded on each sp rank, on the same frames; only the
  model's activations are split. The gather's backward hands each rank its
  own rows of the gradient, and the world all-reduce above sums the slabs'
  parameter gradients. A BatchNorm model takes its statistics over each
  slab's owned rows (halo rows left out), all-reduced over the whole mesh:
  the global batch's, as GSPMD makes JAX's.
- the returned loss is the global mean, on every rank.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..ops.conv import no_tf32
from . import spatial
from .mesh import all_reduce_


class TrainState(NamedTuple):
    step: int
    params: Any  # trainable fp32 leaf tensors (requires_grad)
    buffers: Any  # batchnorm running stats; {} if none
    optimizer: torch.optim.Optimizer
    scheduler: Any  # the learning-rate decay, stepped once a step


def split_bn_buffers(params: Dict) -> Tuple[Dict, Dict]:
    """Split batchnorm running stats out of a conv_stack parameter dict:
    ``(trainable, buffers)``; buffers is {} for models without BN."""
    trainable, buffers = {}, {}
    for k, v in params.items():
        if k.startswith("bn") and isinstance(v, dict) and "mean" in v:
            trainable[k] = {"scale": v["scale"], "bias": v["bias"]}
            buffers[k] = {"mean": v["mean"], "var": v["var"]}
        else:
            trainable[k] = v
    return trainable, buffers


def merge_bn_buffers(trainable: Dict, buffers: Dict) -> Dict:
    if not buffers:
        return trainable
    merged = dict(trainable)
    for k, stats in buffers.items():
        merged[k] = {**trainable[k], **stats}
    return merged


def leaves(tree) -> List[torch.Tensor]:
    """The tensors of a nested dict, in sorted key order."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in leaves(tree[k])]
    return [tree]


def make_optimizer(lr: float = 1e-3, weight_decay: float = 1e-5,
                   lr_decay_rate: float = 0.955, steps_per_epoch: Optional[int] = None):
    """Adam(wd=1e-5) and a per-epoch decay of 0.955, the reference trainer's.

    Returns ``build(tensors) -> (optimizer, scheduler)``: torch's optimizer
    holds its parameters, so it is made once the parameters exist
    (:func:`init_train_state`). The scheduler is stepped after every
    optimizer step; the learning rate of step ``s`` (from 0) is
    ``lr * lr_decay_rate ** (s // steps_per_epoch)``, optax's staircase
    ``exponential_decay``, and stays ``lr`` without ``steps_per_epoch``.
    :func:`optax_state` and :func:`restore_optax` map the pair to optax's
    state of the JAX package's chain and back.
    """

    def build(tensors):
        opt = torch.optim.Adam(tensors, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                               weight_decay=weight_decay)
        if steps_per_epoch:
            factor = lambda s: lr_decay_rate ** (s // steps_per_epoch)  # noqa: E731
        else:
            factor = lambda s: 1.0  # noqa: E731
        sched = torch.optim.lr_scheduler.LambdaLR(opt, factor)
        sched._steps_per_epoch = steps_per_epoch or None  # read by optax_state
        return opt, sched

    return build


def optax_state(state: TrainState) -> list:
    """``state``'s optimizer and scheduler as optax's state for
    :func:`make_optimizer`'s chain (as the JAX package's ``make_optimizer``
    builds it): ``[None, {"count", "mu", "nu"}, {"count"}]``, the first
    ``add_decayed_weights``' empty state, the last ``None`` without
    ``steps_per_epoch``. ``mu`` and ``nu`` are Adam's ``exp_avg`` and
    ``exp_avg_sq`` of each parameter leaf, found by the tensor itself (zeros
    before its first step); the counts are int32: Adam's step and the
    scheduler's."""
    opt = state.optimizer
    steps = set()

    def moments(node, name):
        if isinstance(node, dict):
            return {k: moments(v, name) for k, v in node.items()}
        st = opt.state.get(node, {})
        if "step" in st:
            steps.add(int(st["step"]))
        if name not in st:
            return np.zeros(tuple(node.shape), np.float32)
        return st[name].detach().cpu().numpy()

    mu, nu = moments(state.params, "exp_avg"), moments(state.params, "exp_avg_sq")
    if len(steps) > 1:
        raise ValueError(f"Adam's parameters took different numbers of steps: {sorted(steps)}")
    count = np.int32(steps.pop() if steps else 0)
    sched = state.scheduler
    schedule = (None if getattr(sched, "_steps_per_epoch", None) is None
                else {"count": np.int32(sched.last_epoch)})
    return [None, {"count": count, "mu": mu, "nu": nu}, schedule]


def restore_optax(state: TrainState, opt_state) -> None:
    """Put optax's state of ``make_optimizer``'s chain (:func:`optax_state`)
    into ``state``'s optimizer and scheduler: each parameter leaf's moments
    and Adam's step, and the schedule's count (Adam's where the chain has no
    schedule) with the learning rate it gives."""
    adam = opt_state[1] if isinstance(opt_state, list) and len(opt_state) == 3 else None
    if not isinstance(adam, dict) or set(adam) != {"count", "mu", "nu"}:
        raise ValueError("the checkpoint's opt_state is not make_optimizer's chain "
                         "(add_decayed_weights, scale_by_adam, the learning rate)")
    count = int(adam["count"])
    opt = state.optimizer

    def put(node, mu, nu):
        if isinstance(node, dict):
            for k in node:
                put(node[k], mu[k], nu[k])
        elif count:
            opt.state[node] = {  # a step tensor each, as Adam makes them
                "step": torch.tensor(float(count)),
                "exp_avg": torch.tensor(mu, dtype=node.dtype, device=node.device),
                "exp_avg_sq": torch.tensor(nu, dtype=node.dtype, device=node.device)}
        else:
            opt.state.pop(node, None)

    put(state.params, adam["mu"], adam["nu"])
    sched = state.scheduler
    n = int(opt_state[2]["count"]) if isinstance(opt_state[2], dict) else count
    sched.last_epoch, sched._step_count = n, n + 1
    for group, base, factor in zip(opt.param_groups, sched.base_lrs, sched.lr_lambdas):
        group["lr"] = base * factor(n)
    sched._last_lr = [group["lr"] for group in opt.param_groups]


def init_train_state(params: Dict, optimizer, *, has_batchnorm: bool = False) -> TrainState:
    """A fresh state: the trainable parameters as new fp32 leaves that
    require grad (copies, so the caller's dict is left alone), the
    batchnorm stats as buffers, and ``optimizer`` (from
    :func:`make_optimizer`) built over the trainable leaves."""
    if has_batchnorm:
        trainable, buffers = split_bn_buffers(params)
    else:
        trainable, buffers = params, {}

    def own(node, grad):
        if isinstance(node, dict):
            return {k: own(v, grad) for k, v in node.items()}
        return node.detach().to(torch.float32).clone().requires_grad_(grad)

    trainable, buffers = own(trainable, True), own(buffers, False)
    opt, sched = optimizer(leaves(trainable))
    return TrainState(0, trainable, buffers, opt, sched)


def make_train_step(
    model_apply: Callable,
    criterion: Callable,
    *,
    has_batchnorm: bool = False,
    compute_dtype=torch.bfloat16,
    mesh=None,
    input_transform: Optional[Callable] = None,
):
    """Build ``train_step(state, lr_batch, hr_batch) -> (state, loss)``.

    Batches are (micro, per_micro, H, W, C): the leading axis is the
    gradient accumulation; under a ``mesh`` they are this rank's block
    (``parallel.mesh.accum_batch_sharding``). ``input_transform`` (e.g.
    ``data.dataset.batch_transform`` for uint8 batches) runs per micro-batch
    on the device. ``model_apply`` must be differentiable: for pix_shuffle it
    is ``models.train_apply(model)``, the eager forward; when the mesh's sp
    is above 1 it must be, since the split's halo is that model's receptive
    radius (``parallel.spatial.model_halo``).
    The returned loss is the mean over micro-batches (and over the mesh), a
    device tensor (no sync with the host). The state's parameters and
    optimizer are updated in place; the returned state has the step count
    and the batchnorm stats of this step.
    """
    split = mesh is not None and mesh.sp > 1
    if split and not hasattr(model_apply, "model"):
        raise ValueError("a mesh with sp > 1 needs models.train_apply(model), whose "
                         "model gives the split's halo")
    halo = spatial.model_halo(model_apply.model) if split else None
    bn_kw = {}
    if has_batchnorm and mesh is not None:
        # a slab's statistics join every rank's; without sp, the dp ranks'
        bn_kw["bn_group"] = mesh.world_group if split else mesh.dp_group
    if input_transform is None:
        input_transform = lambda x: x  # noqa: E731

    def forward(params, x):
        if split:
            slab_kw = dict(sp=mesh.sp, index=mesh.sp_index, halo=halo)
            if has_batchnorm:
                y, stats = spatial.apply_slab(model_apply, params, x, train=True, **slab_kw,
                                              **bn_kw)
            else:
                y, stats = spatial.apply_slab(model_apply, params, x, **slab_kw), {}
            return spatial.gather_rows(y.float(), mesh), stats
        if has_batchnorm:
            return model_apply(params, x, train=True, **bn_kw)
        return model_apply(params, x), {}

    def loss_fn(params, lr_mb, hr_mb):
        if split:  # whole frames of this dp shard on every rank of the sp group
            lr_mb, hr_mb = spatial.gather_rows(lr_mb, mesh), spatial.gather_rows(hr_mb, mesh)
        x = input_transform(lr_mb).to(compute_dtype)
        hr_mb = input_transform(hr_mb)
        y, bn_updates = forward(params, x)
        # only the running stats: scale and bias are trainable
        bn_updates = {k: {"mean": v["mean"], "var": v["var"]} for k, v in bn_updates.items()}
        return criterion(y.float(), hr_mb.float()), bn_updates

    def train_step(state: TrainState, lr_batch, hr_batch):
        tensors = leaves(state.params)
        for p in tensors:
            p.grad = None
        n_micro = lr_batch.shape[0]
        buffers = state.buffers
        loss_sum = torch.zeros((), dtype=torch.float32, device=lr_batch.device)
        with no_tf32():
            for i in range(n_micro):
                loss, bn_updates = loss_fn(merge_bn_buffers(state.params, buffers),
                                           lr_batch[i], hr_batch[i])
                loss.backward()
                loss_sum += loss.detach()
                if bn_updates:
                    buffers = {**buffers, **bn_updates}
        for p in tensors:
            if p.grad is None:  # a parameter the forward did not reach
                p.grad = torch.zeros_like(p)
            p.grad.div_(n_micro)
        if mesh is not None and mesh.world_group is not None:
            # the slabs' gradients add up to their frame's; the dp shards'
            # sum over dp is the global batch's mean
            for p in tensors:
                all_reduce_(p.grad, mesh.world_group).div_(mesh.dp)
            all_reduce_(loss_sum, mesh.world_group).div_(mesh.size)
        state.optimizer.step()
        state.scheduler.step()
        return state._replace(step=state.step + 1, buffers=buffers), loss_sum / n_micro

    return train_step
