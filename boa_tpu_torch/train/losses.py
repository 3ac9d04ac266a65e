"""Segmentation losses on channels-last logits, float32 accumulation.

Counterpart of `boa_tpu/train/losses.py` (nnU-Net's
`training/loss/{dice,robust_ce_loss,compound_losses,deep_supervision}.py`):
memory-efficient soft dice with batch dice, smooth 1e-5 and the
denominator clamped at 1e-8; CE on integer targets; top-k CE (k = 10 %,
optional label smoothing); Dice + CE with the dice term's background left
out; the deep-supervision weights 1/2^i with the lowest head zeroed; the
online pseudo dice; and the region family (sigmoid dice + BCE over
multi-hot targets). Logits are (N, X, Y, Z, C), targets (N, X, Y, Z) int.
Plain torch under autograd: the reference's losses are XLA, not Pallas.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def _one_hot(target: torch.Tensor, num_classes: int) -> torch.Tensor:
    # a bool compare, not F.one_hot's int64 volume (4 GB at 118 classes, 2x128^3)
    classes = torch.arange(num_classes, device=target.device)
    return (target[..., None] == classes).float()


def _spatial(t: torch.Tensor) -> tuple[int, ...]:
    return tuple(range(1, t.dim() - 1))


def _dice(intersect, sum_pred, sum_gt, batch_dice: bool, smooth: float):
    if batch_dice:
        intersect, sum_pred, sum_gt = intersect.sum(0), sum_pred.sum(0), sum_gt.sum(0)
    return (2.0 * intersect + smooth) / torch.clamp(sum_gt + sum_pred + smooth, min=1e-8)


def _global(reduce, batch_dice: bool, *sums):
    """The batch dice sums over every rank of a device mesh: each summed over
    the local batch, then `reduce`d (all-reduced) in one call."""
    if not batch_dice:
        raise ValueError("a loss over a device mesh needs batch dice")
    parts = [t.sum(0) for t in sums]
    flat = reduce(torch.cat([p.reshape(-1) for p in parts]))
    return [f.view_as(p) for f, p in zip(torch.split(flat, [p.numel() for p in parts]), parts)]


def _mean(values: torch.Tensor, reduce) -> torch.Tensor:
    if reduce is None:
        return values.mean()
    s = reduce(torch.stack([values.sum(), values.new_tensor(float(values.numel()))]))
    return s[0] / s[1]


def soft_dice_loss(logits: torch.Tensor, target: torch.Tensor, *,
                   batch_dice: bool = True, do_bg: bool = False,
                   smooth: float = 1e-5,
                   loss_mask: torch.Tensor | None = None, reduce=None) -> torch.Tensor:
    """Memory-efficient soft dice (`dice.py:58-120`), the negated score.
    `reduce` (a sum over the ranks of a mesh) makes the sums global."""
    n_cls = logits.shape[-1]
    probs = torch.softmax(logits.float(), dim=-1)
    y = _one_hot(target, n_cls)
    if not do_bg:
        probs, y = probs[..., 1:], y[..., 1:]
    sp = _spatial(probs)
    if loss_mask is not None:
        m = loss_mask[..., None].float()
        intersect = (probs * y * m).sum(sp)
        sum_pred = (probs * m).sum(sp)
        sum_gt = (y * m).sum(sp)
    else:
        intersect = (probs * y).sum(sp)
        sum_pred = probs.sum(sp)
        sum_gt = y.sum(sp)
    if reduce is not None:
        intersect, sum_pred, sum_gt = _global(reduce, batch_dice, intersect, sum_pred, sum_gt)
        return -_dice(intersect, sum_pred, sum_gt, False, smooth).mean()
    return -_dice(intersect, sum_pred, sum_gt, batch_dice, smooth).mean()


def _nll(logp: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return -torch.gather(logp, -1, target.long()[..., None])[..., 0]


def softmax_ce_loss(logits: torch.Tensor, target: torch.Tensor,
                    loss_mask: torch.Tensor | None = None, reduce=None) -> torch.Tensor:
    """Cross-entropy on integer labels (RobustCrossEntropyLoss); with
    `reduce`, the mean over every rank's voxels."""
    nll = _nll(torch.log_softmax(logits.float(), dim=-1), target)
    if loss_mask is not None:
        m = loss_mask.float()
        return (nll * m).sum() / torch.clamp(m.sum(), min=1.0)
    return _mean(nll, reduce)


def topk_ce_loss(logits: torch.Tensor, target: torch.Tensor,
                 k_percent: float = 10.0,
                 label_smoothing: float = 0.0) -> torch.Tensor:
    """Mean of the worst k % voxel losses (`robust_ce_loss.py:22-31`); with
    label smoothing ε the voxel loss is (1 - ε)·nll + ε·mean_c(-logp_c)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = _nll(logp, target)
    if label_smoothing > 0.0:
        nll = (1 - label_smoothing) * nll - label_smoothing * logp.mean(-1)
    nll = nll.reshape(-1)
    k = max(1, int(nll.numel() * k_percent / 100.0))
    return torch.topk(nll, k, sorted=False)[0].mean()


def dice_ce_loss(logits: torch.Tensor, target: torch.Tensor, *,
                 batch_dice: bool = True, weight_ce: float = 1.0,
                 weight_dice: float = 1.0, smooth: float = 1e-5,
                 loss_mask: torch.Tensor | None = None, reduce=None) -> torch.Tensor:
    """DC_and_CE_loss (`compound_losses.py:9-47`): dice without background
    plus CE, one log-softmax feeding both terms as in the reference. With
    `reduce` (a sum over the ranks of a mesh) the dice sums and the CE mean
    are global."""
    n_cls = logits.shape[-1]
    logp = torch.log_softmax(logits.float(), dim=-1)
    probs = torch.exp(logp)
    y = _one_hot(target, n_cls)
    probs_fg, y_fg = probs[..., 1:], y[..., 1:]
    sp = _spatial(probs)
    nll = _nll(logp, target)
    if loss_mask is not None:
        m = loss_mask[..., None].float()
        intersect = (probs_fg * y_fg * m).sum(sp)
        sum_pred = (probs_fg * m).sum(sp)
        sum_gt = (y_fg * m).sum(sp)
        mm = loss_mask.float()
        ce = (nll * mm).sum() / torch.clamp(mm.sum(), min=1.0)
    else:
        intersect = (probs_fg * y_fg).sum(sp)
        sum_pred = probs_fg.sum(sp)
        sum_gt = y_fg.sum(sp)
        ce = _mean(nll, reduce)
    if reduce is not None and loss_mask is None:
        intersect, sum_pred, sum_gt = _global(reduce, batch_dice, intersect, sum_pred, sum_gt)
        batch_dice = False   # summed over the batch already
    dc = -_dice(intersect, sum_pred, sum_gt, batch_dice, smooth).mean()
    return weight_ce * ce + weight_dice * dc


def dice_topk_loss(logits: torch.Tensor, target: torch.Tensor, *,
                   batch_dice: bool = True, k_percent: float = 10.0) -> torch.Tensor:
    """DC_and_topk_loss: dice (no background, smooth 1e-5) + top-10 % CE."""
    return (soft_dice_loss(logits, target, batch_dice=batch_dice)
            + topk_ce_loss(logits, target, k_percent=k_percent))


def make_loss(name: str, *, batch_dice: bool = True, reduce=None):
    """Loss of a trainer-variant family, name -> fn(logits, target):
    dice_ce (default) | dice_ce_nosmooth | ce | dice | topk10 | topk10_ls01
    | dice_topk10. `reduce` (a sum over the ranks of a device mesh) makes the
    first four global; the top-k losses have no such form (ValueError)."""
    if reduce is not None and name.startswith(("topk", "dice_topk")):
        raise ValueError(f"loss {name!r} does not run over a device mesh")
    table = {
        "dice_ce": lambda o, t: dice_ce_loss(o, t, batch_dice=batch_dice, reduce=reduce),
        "dice_ce_nosmooth": lambda o, t: dice_ce_loss(o, t, batch_dice=batch_dice,
                                                      smooth=0.0, reduce=reduce),
        "ce": lambda o, t: softmax_ce_loss(o, t, reduce=reduce),
        "dice": lambda o, t: soft_dice_loss(o, t, batch_dice=batch_dice, reduce=reduce),
        "topk10": lambda o, t: topk_ce_loss(o, t, k_percent=10.0),
        "topk10_ls01": lambda o, t: topk_ce_loss(o, t, k_percent=10.0,
                                                 label_smoothing=0.1),
        "dice_topk10": lambda o, t: dice_topk_loss(o, t, batch_dice=batch_dice),
    }
    try:
        return table[name]
    except KeyError:
        raise ValueError(f"unknown loss {name!r}; one of {sorted(table)}")


def ds_weights(n_outputs: int) -> np.ndarray:
    """Deep-supervision weights (`nnUNetTrainer.py:410-418`): 1/2^i, the
    lowest-resolution head zeroed, normalized to sum 1."""
    w = np.array([1.0 / (2.0 ** i) for i in range(n_outputs)])
    if n_outputs > 1:
        w[-1] = 0.0
    return w / w.sum()


def downsample_target(target: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """Nearest label downsampling for a deep-supervision head, the reference's
    `jax.image.resize(..., "nearest")`: output i takes input
    floor((i + 0.5)·n_in/n_out), computed in float32."""
    if tuple(target.shape[1:]) == tuple(shape):
        return target
    out = target
    for ax, n in enumerate(shape, start=1):
        m = target.shape[ax]
        if m == n:
            continue
        idx = np.floor(((np.arange(n, dtype=np.float32) + np.float32(0.5))
                        * np.float32(m) / np.float32(n)).astype(np.float32))
        out = torch.index_select(out, ax, torch.from_numpy(idx.astype(np.int64))
                                 .to(target.device))
    return out


def deep_supervision_loss(outputs: Sequence[torch.Tensor], target: torch.Tensor, *,
                          batch_dice: bool = True, loss_fn=None) -> torch.Tensor:
    """The weighted base loss over every head, highest resolution first (as
    `forward(all_heads=True)` returns them), the target nearest-downsampled
    per head; `loss_fn` defaults to Dice + CE."""
    if loss_fn is None:
        loss_fn = lambda o, t: dice_ce_loss(o, t, batch_dice=batch_dice)  # noqa: E731
    total = torch.zeros((), dtype=torch.float32, device=target.device)
    for wi, out in zip(ds_weights(len(outputs)), outputs):
        if wi == 0.0:
            continue
        total = total + float(wi) * loss_fn(out, downsample_target(target, out.shape[1:-1]))
    return total


def pseudo_dice(logits: torch.Tensor, target: torch.Tensor, reduce=None) -> torch.Tensor:
    """Per-class hard dice on one head (`nnUNetTrainer.py:1040-1086`), (C-1,)
    foreground classes; NaN where a class is neither present nor predicted.
    `reduce` (a sum over the ranks of a mesh) makes the counts global."""
    n_cls = logits.shape[-1]
    p = _one_hot(torch.argmax(logits, dim=-1), n_cls)[..., 1:]
    y = _one_hot(target, n_cls)[..., 1:]
    axes = tuple(range(0, p.dim() - 1))
    counts = torch.stack([(p * y).sum(axes), (p * (1 - y)).sum(axes),
                          ((1 - p) * y).sum(axes)])
    if reduce is not None:
        counts = reduce(counts)
    tp, fp, fn = counts
    denom = 2 * tp + fp + fn
    return torch.where(denom > 0, 2 * tp / torch.clamp(denom, min=1e-8),
                       torch.full_like(denom, float("nan")))


def soft_dice_loss_sigmoid(logits: torch.Tensor, target_onehot: torch.Tensor, *,
                           batch_dice: bool = True, smooth: float = 1e-5) -> torch.Tensor:
    """Region dice: sigmoid heads against multi-hot region targets."""
    probs = torch.sigmoid(logits.float())
    y = target_onehot.float()
    sp = _spatial(probs)
    return -_dice((probs * y).sum(sp), probs.sum(sp), y.sum(sp), batch_dice,
                  smooth).mean()


def dice_bce_loss(logits: torch.Tensor, target_onehot: torch.Tensor, *,
                  batch_dice: bool = True, weight_ce: float = 1.0,
                  weight_dice: float = 1.0) -> torch.Tensor:
    """DC_and_BCE_loss (`compound_losses.py:50-88`): sigmoid dice with
    background + BCE with logits."""
    dc = soft_dice_loss_sigmoid(logits, target_onehot, batch_dice=batch_dice)
    z = logits.float()
    y = target_onehot.float()
    bce = (torch.clamp(z, min=0) - z * y + torch.log1p(torch.exp(-z.abs()))).mean()
    return weight_ce * bce + weight_dice * dc


def regions_to_multihot(target: torch.Tensor,
                        regions: Sequence[Sequence[int]]) -> torch.Tensor:
    """Integer labels -> (..., R) float multi-hot: a voxel is in every region
    whose label set holds its label (`convert_labels_to_regions`)."""
    chans = []
    for region in regions:
        labels = (region,) if isinstance(region, int) else tuple(region)
        m = torch.zeros(target.shape, dtype=torch.bool, device=target.device)
        for lb in labels:
            m = m | (target == lb)
        chans.append(m)
    return torch.stack(chans, dim=-1).float()


def deep_supervision_loss_regions(outputs: Sequence[torch.Tensor], target: torch.Tensor,
                                  regions: Sequence[Sequence[int]], *,
                                  batch_dice: bool = True) -> torch.Tensor:
    """Weighted Dice + BCE over every head for region-based training."""
    total = torch.zeros((), dtype=torch.float32, device=target.device)
    for wi, out in zip(ds_weights(len(outputs)), outputs):
        if wi == 0.0:
            continue
        t = downsample_target(target, out.shape[1:-1])
        total = total + float(wi) * dice_bce_loss(out, regions_to_multihot(t, regions),
                                                  batch_dice=batch_dice)
    return total


def pseudo_dice_regions(logits: torch.Tensor, target: torch.Tensor,
                        regions: Sequence[Sequence[int]]) -> torch.Tensor:
    """Per-region hard dice of sigmoid heads thresholded at 0.5."""
    p = (logits.float() > 0.0).float()
    y = regions_to_multihot(target, regions)
    axes = tuple(range(0, p.dim() - 1))
    tp = (p * y).sum(axes)
    fp = (p * (1 - y)).sum(axes)
    fn = ((1 - p) * y).sum(axes)
    return 2 * tp / torch.clamp(2 * tp + fp + fn, min=1e-8)
