"""Real-format nnU-Net checkpoints from a parameter pytree (test support).

`checkpoint_final.pth` as nnUNetTrainer saves it (`nnUNetTrainer.py:
1149-1210`): the network's state dict under ``network_weights`` in
dynamic_network_architectures' module names, and beside it the trainer's
name, its ``init_args`` (plans, configuration, fold, dataset.json, device:
not tensors, so loading needs ``weights_only=False``) and the mirror axes
inference may use. The state dict carries the aliases a real one does:
each conv block's ``all_modules.N`` copies of its conv and norm, and the
decoder's registered copy of the encoder (``decoder.encoder.*``), which
share their tensors with the primary keys.

The pytree is the reference's numpy layout (`weights/convert.py`), e.g.
from `weights/store.py:init_params_numpy`, so a full-width checkpoint is
written without the reference package or a torch copy of the network.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from boa_tpu_torch.models.unet import ArchConfig


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32)))


def _kernel(a) -> torch.Tensor:
    # (kx, ky, kz, ci, co) -> torch (co, ci, kx, ky, kz); the transposed
    # conv's XYZOI (kx, ky, kz, co, ci) -> (ci, co, kx, ky, kz) alike
    return _t(np.asarray(a).transpose(4, 3, 0, 1, 2))


def _conv(out: dict, prefix: str, p: dict) -> list[torch.Tensor]:
    ts = [_kernel(p["w"])]
    out[f"{prefix}weight"] = ts[0]
    if "b" in p:
        ts.append(_t(p["b"]))
        out[f"{prefix}bias"] = ts[1]
    return ts


def _norm(out: dict, prefix: str, p: dict) -> None:
    if "norm_scale" in p:
        out[f"{prefix}weight"] = _t(p["norm_scale"])
    if "norm_bias" in p:
        out[f"{prefix}bias"] = _t(p["norm_bias"])


def _conv_block(out: dict, prefix: str, p: dict) -> None:
    """ConvDropoutNormReLU: conv, norm, then its `all_modules` Sequential
    (0 the conv, 1 the norm) naming the same tensors again."""
    own: dict = {}
    _conv(own, "conv.", p)
    _norm(own, "norm.", p)
    for k, v in list(own.items()):
        own[k.replace("conv.", "all_modules.0.").replace("norm.", "all_modules.1.")] = v
    out.update({prefix + k: v for k, v in own.items()})


def _encoder(params: dict, cfg: ArchConfig) -> dict:
    out: dict = {}
    if cfg.residual_encoder:
        _conv_block(out, "encoder.stem.convs.0.", params["stem"])
        for s, stage in enumerate(params["encoder"]):
            for b, blk in enumerate(stage):
                pre = f"encoder.stages.{s}.{b}."
                _conv_block(out, pre + "conv1.", blk["conv1"])
                _conv_block(out, pre + "conv2.", blk["conv2"])
                if "skip" in blk:  # nn.Sequential(conv, norm)
                    _conv(out, pre + "skip.0.", blk["skip"])
                    _norm(out, pre + "skip.1.", blk["skip"])
    else:
        for s, stage in enumerate(params["encoder"]):
            for b, blk in enumerate(stage):
                _conv_block(out, f"encoder.stages.{s}.convs.{b}.", blk)
    return out


def network_weights(params: dict, cfg: ArchConfig) -> dict[str, torch.Tensor]:
    """The state dict of dynamic_network_architectures' PlainConvUNet or
    ResidualEncoderUNet holding `params`, in its key order."""
    out = _encoder(params, cfg)
    out.update({"decoder." + k: v for k, v in list(out.items())})
    for i, st in enumerate(params["decoder"]):
        _conv(out, f"decoder.transpconvs.{i}.", st["transp"])
    for i, st in enumerate(params["decoder"]):
        for b, blk in enumerate(st["convs"]):
            _conv_block(out, f"decoder.stages.{i}.convs.{b}.", blk)
    for i, head in enumerate(params["seg_heads"]):
        _conv(out, f"decoder.seg_layers.{i}.", head)
    return out


def checkpoint(params: dict, cfg: ArchConfig, *, trainer_name: str = "nnUNetTrainer",
               configuration: str = "3d_fullres", fold: int = 0,
               mirror_axes=(0, 1, 2), plans: dict | None = None,
               dataset_json: dict | None = None) -> dict:
    """A `checkpoint_final.pth` dict as nnUNetTrainer writes it at the end
    of training (no optimizer or grad-scaler state)."""
    return {
        "network_weights": network_weights(params, cfg),
        "optimizer_state": None,
        "grad_scaler_state": None,
        "logging": {"train_losses": [], "val_losses": [], "ema_fg_dice": []},
        "_best_ema": None,
        "current_epoch": 1000,
        "init_args": {
            "plans": plans or {"plans_name": "nnUNetPlans"},
            "configuration": configuration,
            "fold": fold,
            "dataset_json": dataset_json or {},
            "device": torch.device("cuda"),
        },
        "trainer_name": trainer_name,
        "inference_allowed_mirroring_axes": tuple(mirror_axes),
    }


def save_checkpoint(path: str | Path, params: dict, cfg: ArchConfig, **kw) -> Path:
    """`torch.save` of `checkpoint(params, cfg, **kw)` to `path`."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(checkpoint(params, cfg, **kw), path)
    return path
