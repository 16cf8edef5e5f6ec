"""The train step's fp32 gradient held to an fp64 one that takes the same
branch at every kink.

A piecewise op (an L1 term's sign, a ReLU's mask, a clip, a max-pool's
argmax) has a subgradient at its switch, and which side a value within
rounding of the switch falls on is rounding's choice: an fp64 step and an
fp32 step may take different sides, and on a parameter whose gradient sum
nearly cancels that moves the fp32 gradient by about 1% of its largest
element. :func:`kink_mode` records the branches of the fp32 step, running
its ops as they are, and replays them in the fp64 step; the two gradients
then differ by the fp32 arithmetic's rounding alone.

That rounding is proportional to the magnitude a gradient element is summed
from, not to the sum: an activation's scalar parameter takes one term from
every element of the layer, and where those cancel (a trained parameter
near its optimum) the sum can be a thousandth of the sum of their
magnitudes. :func:`contribution_mode` measures that magnitude in the fp64
step for every leaf an elementwise op broadcasts (conv biases, activation
parameters).

    decisions, sums = [], []
    loss, grads = fp32_step(m, weights, lr_b, hr_b, "cuda", decisions)
    loss64, grads64, replayed = fp64_step(m, weights, lr_b, hr_b, "cuda", decisions, sums)
"""
from __future__ import annotations

import contextlib
import os


def kink_mode(decisions: list, replay: bool):
    """A torch function mode that records, or replays, the branch each
    piecewise op takes: the side an L1 term's ``torch.where`` picks, a ReLU's
    mask, the side (or tie) of ``torch.maximum``/``torch.minimum`` (the
    clips, relu6), a max-pool's argmax.

    Recording (``replay=False``) calls every op unchanged and appends its
    decision to ``decisions`` in call order (computed apart, without
    gradient), so the recorded run's values and gradients are those of a
    run without the mode. Replaying rewrites the same ops, called in the
    same order with the same shapes, to take those decisions, each with its
    own derivative rule at the recorded side (a tie of ``maximum`` or
    ``minimum`` gives each side half, torch's and JAX's rule). A kink the
    mode does not know raises in either mode."""
    import torch
    import torch.nn.functional as F
    from torch.overrides import TorchFunctionMode

    unknown = {torch.clamp, torch.Tensor.clamp, torch.abs, torch.Tensor.abs, torch.sign,
               F.relu, torch.Tensor.relu, F.leaky_relu}

    class KinkMode(TorchFunctionMode):
        i = 0

        def decide(self, kind, value):
            """Record ``value`` as the decision, or return the recorded one."""
            if not replay:
                decisions.append((kind, tuple(value.shape), value))
                return value
            want = (kind, tuple(value.shape))
            if self.i >= len(decisions) or decisions[self.i][:2] != want:
                have = decisions[self.i][:2] if self.i < len(decisions) else "nothing"
                raise RuntimeError(f"replay at {want}: the record has {have}")
            self.i += 1
            return decisions[self.i - 1][2]

        def __torch_function__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if func in unknown:
                raise RuntimeError(f"kink_mode does not replay {func.__name__}")
            if func is torch.where and len(args) == 3 and not kwargs:
                cond = self.decide("where", args[0])
                if replay:
                    return torch.where(cond, args[1], args[2])
            elif func is torch.relu and not kwargs:
                x = args[0]
                with torch.no_grad():
                    mask = self.decide("relu", x > 0)
                if replay:
                    return torch.where(mask, x, torch.zeros_like(x))
            elif func in (torch.maximum, torch.minimum) and not kwargs:
                a, b = args
                with torch.no_grad():
                    first = a > b if func is torch.maximum else a < b
                    side = self.decide(func.__name__,
                                       torch.stack(torch.broadcast_tensors(first, a == b)))
                if replay:
                    return torch.where(side[1], (a + b) / 2, torch.where(side[0], a, b))
            elif func is F.max_pool2d and not kwargs.get("return_indices"):
                kw = {k: v for k, v in kwargs.items() if k != "return_indices"}
                with torch.no_grad():
                    idx = self.decide("max_pool2d",
                                      F.max_pool2d(*args, **kw, return_indices=True)[1])
                if replay:
                    x = args[0]
                    return x.flatten(2).gather(2, idx.flatten(2)).view(idx.shape)
            return func(*args, **kwargs)

    return KinkMode()


# the elementwise ops that broadcast a parameter over an activation
_ELEMENTWISE = {"add", "sub", "mul", "div", "add_", "sub_", "mul_", "div_",
                "__add__", "__radd__", "__sub__", "__rsub__", "__mul__", "__rmul__",
                "__truediv__", "__rtruediv__"}
_ALIASES = {"reshape", "view", "to"}


def contribution_mode(leaves: list, sums: list):
    """A torch function mode that finds, for each leaf ``leaves[i]`` that an
    elementwise op broadcasts over a larger tensor, the terms its gradient
    adds up: the broadcast operand is expanded to the op's shape, with a hook
    on the expansion that keeps its gradient (the same sum follows). A leaf
    is followed through ``reshape``, ``view`` and ``to`` that keep its size.
    :meth:`total`, called after the mode, sets ``sums[i]`` to the sum of the
    terms' magnitudes (``None`` for a leaf used otherwise, such as a conv's
    weights). The hooks run no op, since other modes may be on then."""
    import torch
    from torch.overrides import TorchFunctionMode

    class ContributionMode(TorchFunctionMode):
        def __init__(self):
            super().__init__()
            # holding the tensors keeps their ids unique while the mode lives
            self.leaf = {id(t): (i, t) for i, t in enumerate(leaves)}
            self.terms = []

        def total(self):
            sums[:] = [None] * len(leaves)
            for i, size, g in self.terms:
                s = g.abs().sum_to_size(size).reshape(leaves[i].shape)
                sums[i] = s if sums[i] is None else sums[i] + s
            self.terms.clear()

        def spread(self, a, shape):
            if not isinstance(a, torch.Tensor) or id(a) not in self.leaf or a.shape == shape:
                return a
            i = self.leaf[id(a)][0]
            e = a.expand(shape)
            e.register_hook(lambda g, i=i, size=a.shape: self.terms.append((i, size, g)))
            return e

        def __torch_function__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            name = getattr(func, "__name__", "")
            if name in _ALIASES and args and id(args[0]) in self.leaf:
                out = func(*args, **kwargs)
                if isinstance(out, torch.Tensor) and out.numel() == args[0].numel():
                    self.leaf.setdefault(id(out), (self.leaf[id(args[0])][0], out))
                return out
            if name in _ELEMENTWISE:
                shape = torch.broadcast_shapes(
                    *(a.shape for a in args if isinstance(a, torch.Tensor)))
                args = tuple(self.spread(a, shape) for a in args)
            return func(*args, **kwargs)

    return ContributionMode()


def fp32_step(m, weights, lr_b, hr_b, device, decisions=None):
    """One train step of ``m`` in fp32 on ``device`` from ``weights`` (fp32,
    nested dict) at lr 0, the uint8 batch ``lr_b``/``hr_b`` taken as that
    many micro-batches of 1, as the trainer accumulates them. With
    ``decisions`` its kinks are recorded there (:func:`kink_mode`). Returns
    ``(loss, [leaf gradients, fp64 on the CPU])``."""
    import torch

    from ..data import batch_transform
    from ..losses import build_criterion
    from ..models import train_apply
    from ..parallel import train_step as ts

    state = ts.init_train_state({k: {n: t.to(device) for n, t in v.items()}
                                 for k, v in weights.items()},
                                ts.make_optimizer(lr=0.0, weight_decay=0.0))
    step = ts.make_train_step(train_apply(m), build_criterion(m.loss, device=device),
                              compute_dtype=torch.float32, input_transform=batch_transform(True))
    mode = kink_mode(decisions, replay=False) if decisions is not None else None
    with mode or contextlib.nullcontext():
        _, loss = step(state, torch.from_numpy(lr_b[:, None]).to(device),
                       torch.from_numpy(hr_b[:, None]).to(device))
    return loss.item(), [p.grad.cpu().double() for p in ts.leaves(state.params)]


def fp64_step(m, weights, lr_b, hr_b, device, decisions=None, sums=None):
    """The reference for :func:`fp32_step`: the model's eager forward and its
    criterion in fp64 on ``device`` on each micro-batch of 1, the gradients
    summed and averaged as the step does, from the same fp32 inputs
    (``batch_transform``). With ``decisions`` (recorded around the fp32 step)
    every kink takes the fp32 step's branch. With ``sums``, it is filled as
    :func:`contribution_mode` says (on the CPU). Returns ``(loss, [leaf
    gradients on the CPU], kinks replayed)``."""
    import torch

    from ..data import batch_transform
    from ..losses import build_criterion
    from ..models import train_apply
    from ..parallel import train_step as ts

    p = {k: {n: t.to(device).double().requires_grad_() for n, t in v.items()}
         for k, v in weights.items()}
    crit, fwd = build_criterion(m.loss, device=device), train_apply(m)
    to_float = batch_transform(True)
    total = 0.0
    n = len(lr_b)
    mode = kink_mode(decisions, replay=True) if decisions is not None else None
    terms = contribution_mode(ts.leaves(p), sums) if sums is not None else None
    with terms or contextlib.nullcontext(), mode or contextlib.nullcontext():
        for i in range(n):
            x = to_float(torch.from_numpy(lr_b[i:i + 1]).to(device)).double()
            y = to_float(torch.from_numpy(hr_b[i:i + 1]).to(device)).double()
            loss = crit(fwd(p, x), y) / n
            loss.backward()
            total += loss.item()
    if terms is not None:
        terms.total()
        sums[:] = [None if s is None else s.cpu() for s in sums]
    return total, [t.grad.cpu() for t in ts.leaves(p)], mode.i if mode else 0


def load_batch(tree: str, styled: tuple):
    """The uint8 batch (lores, targets) of the named styled crops of the
    generator's tree (paths relative to it), in that order, unflipped."""
    import numpy as np
    from PIL import Image

    from ..data import gather_all_samples_from_directory

    with Image.open(os.path.join(tree, styled[0])) as im:
        crop = im.size
    target = {os.path.relpath(a, tree): b
              for a, b in gather_all_samples_from_directory(tree, crop, verbose=0)}
    out = []
    for paths in zip(styled, (target[s] for s in styled)):
        arrs = []
        for path in paths:
            with Image.open(os.path.join(tree, path)) as im:
                arrs.append(np.asarray(im.convert("RGB")))
        out.append(arrs)
    return np.stack([a for a, _ in out]), np.stack([b for _, b in out])


def leaf_names(tree, prefix: str = "") -> list:
    """Dotted names of a nested dict's tensors, in ``train_step.leaves``'
    order."""
    names = []
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            names += leaf_names(tree[k], prefix + k + ".")
        else:
            names.append(prefix + k)
    return names

