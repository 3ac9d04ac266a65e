"""Parameter archives and the one bridge from the reference's layout.

Counterpart of `boa_tpu/weights/convert.py` (`save_params_npz`,
`load_params_npz`). The archives hold the reference's parameter pytree as
numpy arrays in its channels-last layout:

* Conv3d weight (kx, ky, kz, ci, co)
* ConvTranspose3d weight, XYZOI: (kx, ky, kz, co, ci)
* instance norm affine as norm_scale / norm_bias

`params_from_numpy` turns such a pytree into the port's `PlainConvUNet`.
(X, Y, Z) stays torch's (D, H, W), so only the channel axes move.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any

import numpy as np
import torch

from boa_tpu_torch.device import resolve_device
from boa_tpu_torch.models.unet import ArchConfig, ConvBlock, PlainConvUNet


def _flatten(node, prefix: str, out: dict) -> None:
    if isinstance(node, dict):
        for k in sorted(node):
            _flatten(node[k], f"{prefix}{k}/", out)
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            _flatten(v, f"{prefix}{i}/", out)
    else:
        out[prefix[:-1]] = np.asarray(node)


def save_params_npz(params: dict, path: str | Path) -> None:
    """Flatten the pytree to an .npz with '/'-joined key paths."""
    arrays: dict[str, np.ndarray] = {}
    _flatten(params, "", arrays)
    np.savez_compressed(path, **arrays)


def load_params_npz(path: str | Path) -> dict:
    """Rebuild the numpy pytree from an .npz written by save_params_npz."""
    data = np.load(path)
    root: dict[str, Any] = {}
    for name, arr in data.items():
        parts = name.split("/")
        node: Any = root
        for i, p in enumerate(parts[:-1]):
            nxt = parts[i + 1]
            key: Any = int(p) if p.isdigit() else p
            if isinstance(node, dict):
                node = node.setdefault(key, [] if nxt.isdigit() else {})
            else:
                while len(node) <= key:
                    node.append([] if nxt.isdigit() else {})
                node = node[key]
        last = parts[-1]
        lk: Any = int(last) if last.isdigit() else last
        if isinstance(node, dict):
            node[lk] = arr
        else:
            while len(node) <= lk:
                node.append(None)
            node[lk] = arr
    return root


def _t(a, device) -> torch.Tensor:
    return torch.tensor(np.asarray(a), dtype=torch.float32, device=device)


def _kernel(a, device) -> torch.Tensor:
    # (kx, ky, kz, ci, co) -> (co, ci, kx, ky, kz); the transposed conv's
    # (kx, ky, kz, co, ci) -> (ci, co, kx, ky, kz) is the same permutation
    return _t(a, device).permute(4, 3, 0, 1, 2).contiguous()


def _set_block(blk: ConvBlock, p: dict, device) -> None:
    blk.conv.weight.copy_(_kernel(p["w"], device))
    if "b" in p:
        blk.conv.bias.copy_(_t(p["b"], device))
    if "norm_scale" in p:
        blk.norm.weight.copy_(_t(p["norm_scale"], device))
    if "norm_bias" in p:
        blk.norm.bias.copy_(_t(p["norm_bias"], device))


@torch.no_grad()
def params_from_numpy(params_np: dict, cfg: ArchConfig,
                      device=None) -> PlainConvUNet:
    """The reference's parameter pytree (numpy leaves) -> PlainConvUNet on
    `device` (default the card)."""
    device = resolve_device(device)
    model = PlainConvUNet(cfg, device=device)
    for stage, ps in zip(model.encoder, params_np["encoder"], strict=True):
        for blk, p in zip(stage, ps, strict=True):
            _set_block(blk, p, device)
    for st, ps in zip(model.decoder, params_np["decoder"], strict=True):
        st.transp.weight.copy_(_kernel(ps["transp"]["w"], device))
        st.transp.bias.copy_(_t(ps["transp"]["b"], device))
        for blk, p in zip(st.convs, ps["convs"], strict=True):
            _set_block(blk, p, device)
    for head, p in zip(model.seg_heads, params_np["seg_heads"], strict=True):
        head.weight.copy_(_kernel(p["w"], device))
        head.bias.copy_(_t(p["b"], device))
    return model.eval()
