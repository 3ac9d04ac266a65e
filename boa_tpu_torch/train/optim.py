"""Learning-rate schedules, global-norm clipping, the optimizers and their
state carried to and from the reference's checkpoint trees.

Counterpart of `boa_tpu/train/optim.py`. The schedules are host floats:
PolyLR (`lr_scheduler/polylr.py`), CosineAnnealingLR's closed form,
linear warm-up and PolyLR after a warm-up offset. The clip is the
reference's formula, not `clip_grad_norm_`'s: the norm is the square root
of the sum of every gradient's sum of squares, the scale
min(1, max_norm / (norm + 1e-6)), applied without a host sync. The updates
are torch's own optimizers, which the reference's hand updates were written
to equal: SGD with Nesterov momentum (`nnUNetTrainer.py:507-511`), AdamW
(amsgrad for nnUNetTrainerAdam) and Adam with coupled weight decay.

The reference zero-initializes its momentum buffers, torch creates each
one from the first gradient: 0.99·0 + g = g, the same first step. The
carry (`opt_state_to_numpy`, `opt_state_from_numpy`) maps torch's state to
the reference's trees — SGD's ``momentum_buf`` (the parameter tree), the
Adam family's ``{"m", "v", "step"[, "vmax"]}`` — in the parameters'
numpy layout, writing zeros for buffers torch has not created yet.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from boa_tpu_torch.weights.convert import param_codecs, tree_get, tree_set


def poly_lr(initial_lr: float, step, max_steps: int, exponent: float = 0.9) -> float:
    return initial_lr * (1 - step / max_steps) ** exponent


def cosine_anneal_lr(initial_lr: float, step, max_steps: int,
                     eta_min: float = 0.0) -> float:
    """CosineAnnealingLR's closed form (T_max = max_steps)."""
    return eta_min + (initial_lr - eta_min) * 0.5 * (
        1 + math.cos(math.pi * step / max_steps))


def lin_incr_lr(initial_lr: float, step, warmup_steps: int) -> float:
    """Linear warm-up 0 -> initial_lr (`lr_scheduler/warmup.py` Lin_incr)."""
    return initial_lr * min((step + 1) / warmup_steps, 1.0)


def poly_lr_offset(initial_lr: float, step, max_steps: int, offset: int,
                   exponent: float = 0.9) -> float:
    """PolyLR starting after a warm-up offset (PolyLRScheduler_offset)."""
    eff = max(step - offset, 0)
    return initial_lr * (1 - eff / max(max_steps - offset, 1)) ** exponent


def clip_by_global_norm(grads: list[torch.Tensor], max_norm: float) -> torch.Tensor:
    """Scale `grads` in place by min(1, max_norm / (norm + 1e-6)), the norm
    sqrt(sum of every gradient's float32 sum of squares); returns the norm
    before clipping (a device scalar)."""
    norm = torch.sqrt(torch.stack([g.float().square().sum() for g in grads]).sum())
    scale = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    torch._foreach_mul_(grads, scale)
    return norm


def make_optimizer(name: str, params, lr: float, *, momentum: float = 0.99,
                   weight_decay: float = 3e-5,
                   betas: tuple[float, float] = (0.9, 0.999)) -> torch.optim.Optimizer:
    """sgd (Nesterov) | adamw_amsgrad | adamw | adam (coupled decay)."""
    params = list(params)
    if name == "sgd":
        return torch.optim.SGD(params, lr=lr, momentum=momentum, nesterov=True,
                               weight_decay=weight_decay)
    if name in ("adamw_amsgrad", "adamw"):
        return torch.optim.AdamW(params, lr=lr, betas=tuple(betas), eps=1e-8,
                                 weight_decay=weight_decay,
                                 amsgrad=name.endswith("amsgrad"))
    if name == "adam":
        return torch.optim.Adam(params, lr=lr, betas=tuple(betas), eps=1e-8,
                                weight_decay=weight_decay)
    raise ValueError(f"unknown optimizer {name!r}")


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = float(lr)


_ADAM_KEYS = (("m", "exp_avg"), ("v", "exp_avg_sq"), ("vmax", "max_exp_avg_sq"))
# torch's state key -> its key in the reference's tree (None: SGD's momentum,
# which is the parameters' tree itself)
STATE_TREE_KEYS = {"momentum_buffer": None, "step": "step",
                   **{name: key for key, name in _ADAM_KEYS}}


def _is_sgd(optimizer) -> bool:
    return isinstance(optimizer, torch.optim.SGD)


def _amsgrad(optimizer) -> bool:
    return bool(optimizer.param_groups[0].get("amsgrad", False))


def opt_state_to_numpy(model, optimizer: torch.optim.Optimizer):
    """The optimizer's state as the reference's tree: SGD's momentum tree,
    or ``{"m", "v", "step"[, "vmax"]}`` for the Adam family."""
    leaves = param_codecs(model)
    if _is_sgd(optimizer):
        tree: dict = {}
        for path, p, to_np, _ in leaves:
            buf = optimizer.state.get(p, {}).get("momentum_buffer")
            tree_set(tree, path, to_np(buf) if buf is not None
                     else np.zeros(to_np(p).shape, np.float32))
        return tree
    out: dict = {k: {} for k, _ in _ADAM_KEYS if k != "vmax" or _amsgrad(optimizer)}
    step = 0
    for path, p, to_np, _ in leaves:
        st = optimizer.state.get(p, {})
        step = int(st["step"]) if "step" in st else step
        for key, name in _ADAM_KEYS:
            if key in out:
                tree_set(out[key], path, to_np(st[name]) if name in st
                         else np.zeros(to_np(p).shape, np.float32))
    out["step"] = np.asarray(step, np.int32)
    return out


@torch.no_grad()
def opt_state_from_numpy(model, optimizer: torch.optim.Optimizer, tree) -> None:
    """Load the reference's optimizer tree into torch's state. A step count of
    0 leaves the Adam state empty (torch creates it at the first step)."""
    if _is_sgd(optimizer):
        for path, p, _, from_np in param_codecs(model):
            optimizer.state[p]["momentum_buffer"] = from_np(tree_get(tree, path), p)
        return
    step = int(np.asarray(tree["step"]))
    if step == 0:
        return
    for path, p, _, from_np in param_codecs(model):
        st = optimizer.state[p]
        st["step"] = torch.tensor(float(step))
        for key, name in _ADAM_KEYS:
            if key in tree:
                st[name] = from_np(tree_get(tree[key], path), p)
        if _amsgrad(optimizer) and "vmax" not in tree:
            st["max_exp_avg_sq"] = torch.zeros_like(p)
