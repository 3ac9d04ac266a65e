"""Fused-forward PlainConvUNet on the wide-channel conv kernel (K5).

Counterpart of `boa_tpu/models/unet_fused.py` (`pack_unet_params`,
`_materialize`, `_block_fused`, `unet_forward_fused`): an opt-in forward,
called directly with the weights from `pack_unet_params`. Every stride-1
3x3x3 conv block runs through `ops.pallas_conv.conv3d_in_act` with
cross-layer chaining: each conv consumes the previous layer's RAW output
plus its instance-norm statistics (emitted by the kernel as per-channel
sums), so normalized activations are never written to device memory.
Stride-2 downsample convs, odd-kernel blocks, transposed convs, concats and
the 1x1x1 head run eager, with the pending normalization materialized once
at each such boundary. Public layout as in the reference: one sample,
channels-last (X, Y, Z, C).

The conv kernel takes bf16 weights, so `pack_unet_params` rounds them to
bf16 (the reference keeps them in float32 here); the difference stays
within the reference's own bar (tests/test_torch_fused.py).
"""

from __future__ import annotations

from typing import Callable

import torch

from boa_tpu_torch.models.unet import (ArchConfig, ConvBlock, PlainConvUNet,
                                       _affine, _lrelu, _wcl)
from boa_tpu_torch.ops import pallas_conv as pc


def _eligible_encoder(cfg: ArchConfig, s: int, b: int) -> bool:
    stride = cfg.strides[s] if b == 0 else (1, 1, 1)
    return cfg.kernel_sizes[s] == (3, 3, 3) and tuple(stride) == (1, 1, 1)


@torch.no_grad()
def pack_unet_params(model: PlainConvUNet) -> dict:
    """The packed K5 weights of every kernel-eligible conv block, in the
    reference's structure: {"encoder": [[w_packed or None per block] per
    stage], "decoder": [{"convs": [w_packed or None per block]}]}. The model
    is left untouched."""
    cfg = model.cfg

    def pack(blk):
        return pc.pack_in_act_weights(_wcl(blk.conv))

    enc = [[pack(blk) if _eligible_encoder(cfg, s, b) else None
            for b, blk in enumerate(stage)]
           for s, stage in enumerate(model.encoder)]
    dec = []
    for i, st in enumerate(model.decoder):
        s = cfg.n_stages - 1 - i
        ok = cfg.kernel_sizes[s - 1] == (3, 3, 3)
        dec.append({"convs": [pack(blk) if ok else None for blk in st.convs]})
    return {"encoder": enc, "decoder": dec}


def _materialize(x_raw: torch.Tensor, norm: pc.NormAct | None,
                 slope: float) -> torch.Tensor:
    """Apply a pending IN+LReLU (the eager-side boundary materialization)."""
    if norm is None:
        return x_raw
    xn = (x_raw.float() - norm.mean) * (norm.inv_std * norm.gamma) + norm.beta
    return _lrelu(xn, slope).to(x_raw.dtype)


def _eager(mod: torch.nn.Module, x: torch.Tensor) -> torch.Tensor:
    """A torch layer on one channels-last sample."""
    return mod(x[None].permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1)[0]


def _block_fused(blk: ConvBlock, w_packed: torch.Tensor, x_raw: torch.Tensor,
                 norm: pc.NormAct | None, cfg: ArchConfig, conv: Callable):
    """One conv block through the kernel; returns (y_raw, y_norm)."""
    cin, cout = x_raw.shape[-1], blk.conv.out_channels
    dev = x_raw.device
    na = norm if norm is not None else pc.identity_normact(cin, dev)
    y, sums = conv(x_raw, na, None, blk.conv.bias,
                   slope=cfg.nonlin_slope if norm is not None else 1.0,
                   out_dtype=x_raw.dtype, w_packed=w_packed, cin=cin, cout=cout)
    count = x_raw.shape[0] * x_raw.shape[1] * x_raw.shape[2]
    mean, inv = pc.stats_from_sums(sums, count, cfg.norm_eps)
    return y, pc.NormAct(mean, inv, *_affine(blk, cout, dev), cfg.nonlin_slope)


@torch.no_grad()
def unet_forward_fused(model: PlainConvUNet, packed: dict, x: torch.Tensor,
                       conv: Callable = pc.conv3d_in_act) -> torch.Tensor:
    """x: (X, Y, Z, C) single sample -> logits (X, Y, Z, num_classes), in
    x's dtype (the model's parameters must share it). `conv` is the kernel
    wrapper, or `pc.conv3d_in_act_plain` as a yardstick."""
    cfg = model.cfg
    assert not (cfg.residual_encoder or cfg.two_d), "fused path covers the 3d PlainConvUNet"
    slope = cfg.nonlin_slope
    x_raw, norm = x, None
    skips: list[tuple[torch.Tensor, pc.NormAct | None]] = []
    for s, stage in enumerate(model.encoder):
        for b, blk in enumerate(stage):
            wp = packed["encoder"][s][b]
            if wp is not None and _eligible_encoder(cfg, s, b):
                x_raw, norm = _block_fused(blk, wp, x_raw, norm, cfg, conv)
            else:  # stride-2 / odd-kernel: eager conv on the materialized input
                x_raw, norm = _eager(blk, _materialize(x_raw, norm, slope)), None
        skips.append((x_raw, norm))

    y_raw, ynorm = skips[-1]
    for i, st in enumerate(model.decoder):
        s = cfg.n_stages - 1 - i
        up = _eager(st.transp, _materialize(y_raw, ynorm, slope))
        skip_raw, skip_norm = skips[s - 1]
        y_raw = torch.cat([up, _materialize(skip_raw, skip_norm, slope)], dim=-1)
        ynorm = None
        for b, blk in enumerate(st.convs):
            wp = packed["decoder"][i]["convs"][b]
            if wp is not None and cfg.kernel_sizes[s - 1] == (3, 3, 3):
                y_raw, ynorm = _block_fused(blk, wp, y_raw, ynorm, cfg, conv)
            else:
                y_raw, ynorm = _eager(blk, _materialize(y_raw, ynorm, slope)), None

    final = _materialize(y_raw, ynorm, slope)
    return _eager(model.seg_heads[len(model.decoder) - 1], final)
