"""nnU-Net checkpoints, parameter archives, and the port's networks.

Counterpart of `boa_tpu/weights/convert.py` (`load_torch_state_dict`,
`convert_state_dict`, `convert_checkpoint`, `save_params_npz`,
`load_params_npz`). The parameter pytree is the reference's, numpy arrays
in its channels-last layout:

* Conv3d weight (kx, ky, kz, ci, co), from torch's (co, ci, kx, ky, kz)
* ConvTranspose3d weight, XYZOI: (kx, ky, kz, co, ci), from torch's
  (ci, co, kx, ky, kz)
* instance norm affine as norm_scale / norm_bias

A real nnU-Net `checkpoint_final.pth` (`nnUNetTrainer.py:1149-1210`) holds
the torch state dict under ``network_weights`` in dynamic_network_
architectures' module names; regexes map both encoder families (plain
`encoder.stages.S[.J].convs.B.{conv,norm}.*`, residual
`encoder.stem...` and `encoder.stages.S[.J].[blocks.]B.{conv1,conv2,skip}.*`)
and skip the known aliases. `params_from_numpy` turns a pytree into the
port's network (`models/unet.py:make_unet`). (X, Y, Z) stays torch's
(D, H, W), so only the channel axes move.

A `.pth` file is unpickled with `weights_only=False`, as nnU-Net's own
loader does (its ``init_args`` are not tensors): it can run code, so load
only checkpoints you trust.
"""

from __future__ import annotations

import re
from collections import defaultdict
from pathlib import Path
from typing import Any, Mapping

import numpy as np
import torch

from boa_tpu_torch.device import resolve_device
from boa_tpu_torch.io import npz
from boa_tpu_torch.models.unet import (ArchConfig, BasicBlockD, ConvBlock,
                                       PlainConvUNet, make_unet)


def _conv_w(t) -> np.ndarray:
    a = np.asarray(t, dtype=np.float32)
    return np.ascontiguousarray(a.transpose(2, 3, 4, 1, 0))


def _vec(t) -> np.ndarray:
    return np.asarray(t, dtype=np.float32)


def load_torch_state_dict(path: str | Path) -> dict[str, np.ndarray]:
    """The state dict of a `checkpoint_final.pth` (its ``network_weights``,
    or the file itself when it is a bare state dict) as numpy, loaded on the
    CPU, with DDP's ``module.`` and torch.compile's ``_orig_mod.`` prefixes
    stripped. Trusted files only (`weights_only=False`)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    state = ckpt.get("network_weights", ckpt) if isinstance(ckpt, dict) else ckpt
    return {k.removeprefix("module.").removeprefix("_orig_mod."):
            v.detach().cpu().numpy() for k, v in state.items()}


_ENC_PLAIN = re.compile(
    r"^encoder\.stages\.(\d+)\.(?:\d+\.)?convs\.(\d+)\.(conv|norm)\.(weight|bias)$")
_ENC_RES = re.compile(
    r"^encoder\.stages\.(\d+)\.(?:\d+\.)?(?:blocks\.)?(\d+)\."
    r"(conv1|conv2|skip)\.(?:(conv|norm|0|1)\.)?(weight|bias)$")
_STEM = re.compile(r"^encoder\.stem\.(?:\d+\.)?convs\.(\d+)\.(conv|norm)\.(weight|bias)$")
_DEC_TRANSP = re.compile(r"^decoder\.transpconvs\.(\d+)\.(weight|bias)$")
_DEC_CONV = re.compile(
    r"^decoder\.stages\.(\d+)\.(?:\d+\.)?convs\.(\d+)\.(conv|norm)\.(weight|bias)$")
_SEG = re.compile(r"^decoder\.seg_layers\.(\d+)\.(weight|bias)$")
#: keys a real checkpoint carries that hold no parameter of their own: the
#: decoder's registered copy of the encoder (every encoder key again), the
#: `all_modules` Sequential aliases of each conv block, norm buffers
_ALIAS_KEYS = re.compile(
    r"^decoder\.encoder\.|\.all_modules\.|num_batches_tracked$"
    r"|\.running_(mean|var)$")


def _block_set(dst: dict, kind: str, name: str, value) -> None:
    if kind == "conv":
        dst["w" if name == "weight" else "b"] = (_conv_w(value) if name == "weight"
                                                 else _vec(value))
    else:  # norm
        dst["norm_scale" if name == "weight" else "norm_bias"] = _vec(value)


def convert_state_dict(state: Mapping[str, Any], cfg: ArchConfig,
                       strict: bool = False) -> dict:
    """A torch state dict -> the reference's parameter pytree.

    strict=True raises when a key is neither consumed nor a known alias,
    so a checkpoint whose layout is not fully understood fails loudly. A
    residual checkpoint whose stem holds more than one conv raises
    ValueError: the stem here is one conv block."""
    enc: dict = defaultdict(lambda: defaultdict(dict))
    enc_res: dict = defaultdict(
        lambda: defaultdict(lambda: {"conv1": {}, "conv2": {}, "skip": {}}))
    stem: dict = defaultdict(dict)
    dec_t: dict = defaultdict(dict)
    dec_c: dict = defaultdict(lambda: defaultdict(dict))
    seg: dict = defaultdict(dict)
    matched = 0
    unconsumed: list[str] = []
    for key, value in state.items():
        m = _ENC_PLAIN.match(key)
        if m and not cfg.residual_encoder:
            _block_set(enc[int(m[1])][int(m[2])], m[3], m[4], value)
        elif m := _STEM.match(key):
            _block_set(stem[int(m[1])], m[2], m[3], value)
        elif (m := _ENC_RES.match(key)) and cfg.residual_encoder:
            s, b, part, sub, name = int(m[1]), int(m[2]), m[3], m[4], m[5]
            blk = enc_res[s][b]
            if part == "skip":  # skip.0 the conv, skip.1 the norm
                _block_set(blk["skip"], "conv" if sub in ("0", "conv", None)
                           else "norm", name, value)
            else:
                _block_set(blk[part], sub if sub in ("conv", "norm") else "conv",
                           name, value)
        elif m := _DEC_TRANSP.match(key):
            dec_t[int(m[1])]["w" if m[2] == "weight" else "b"] = (
                _conv_w(value) if m[2] == "weight" else _vec(value))
        elif m := _DEC_CONV.match(key):
            _block_set(dec_c[int(m[1])][int(m[2])], m[3], m[4], value)
        elif m := _SEG.match(key):
            seg[int(m[1])]["w" if m[2] == "weight" else "b"] = (
                _conv_w(value) if m[2] == "weight" else _vec(value))
        else:
            if not _ALIAS_KEYS.search(key):
                unconsumed.append(key)
            continue
        matched += 1

    params: dict[str, Any] = {"encoder": [], "decoder": [], "seg_heads": []}
    if cfg.residual_encoder:
        if len(stem) > 1:
            raise ValueError(
                f"checkpoint stem has {len(stem)} convs; this architecture "
                "supports exactly one stem conv block")
        if stem:
            params["stem"] = stem[0]
        for s in range(cfg.n_stages):
            stage = []
            for b in sorted(enc_res[s]):
                blk = dict(enc_res[s][b])
                if not blk["skip"]:
                    del blk["skip"]
                stage.append(blk)
            params["encoder"].append(stage)
    else:
        for s in range(cfg.n_stages):
            params["encoder"].append([enc[s][b] for b in sorted(enc[s])])
    for i in range(cfg.n_stages - 1):
        params["decoder"].append(
            {"transp": dec_t[i], "convs": [dec_c[i][b] for b in sorted(dec_c[i])]})
        params["seg_heads"].append(seg[i])
    if matched == 0:
        raise ValueError("no recognizable nnU-Net keys found in state dict")
    if strict and unconsumed:
        raise ValueError(
            f"{len(unconsumed)} state-dict key(s) not consumed by the "
            f"converter: {unconsumed[:8]}{'...' if len(unconsumed) > 8 else ''}")
    return params


def convert_checkpoint(path: str | Path, cfg: ArchConfig,
                       strict: bool = True) -> dict:
    """A `checkpoint_final.pth` -> the parameter pytree; strict by default,
    so an unknown key layout raises instead of dropping parameters."""
    return convert_state_dict(load_torch_state_dict(path), cfg, strict=strict)


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
    npz.savez_compressed(path, **arrays)


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
    if set(p) - {"w", "b", "norm_scale", "norm_bias"}:
        raise ValueError(f"unknown block parameters {sorted(p)}")
    blk.conv.weight.copy_(_kernel(p["w"], device))
    if "b" in p:
        blk.conv.bias.copy_(_t(p["b"], device))
    if "norm_scale" in p:
        blk.norm.weight.copy_(_t(p["norm_scale"], device))
    if "norm_bias" in p:
        blk.norm.bias.copy_(_t(p["norm_bias"], device))


def _set_residual(blk: BasicBlockD, p: dict, device) -> None:
    if ("skip" in p) != (blk.skip is not None):
        raise ValueError(f"residual block {'with' if 'skip' in p else 'without'} "
                         f"a skip conv where the config says otherwise")
    for part in ("conv1", "conv2", "skip"):
        if part in p:
            _set_block(getattr(blk, part), p[part], device)


@torch.no_grad()
def params_from_numpy(params_np: dict, cfg: ArchConfig,
                      device=None) -> PlainConvUNet:
    """The reference's parameter pytree (numpy leaves) -> the network of
    `cfg`'s family (PlainConvUNet or ResidualEncoderUNet) on `device`
    (default the card). Deep supervision shares the plain layout: one head
    per decoder stage."""
    device = resolve_device(device)
    model = make_unet(cfg, device=device)
    if cfg.residual_encoder:
        _set_block(model.stem, params_np["stem"], device)
    for stage, ps in zip(model.encoder, params_np["encoder"], strict=True):
        for blk, p in zip(stage, ps, strict=True):
            if cfg.residual_encoder:
                _set_residual(blk, p, device)
            else:
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
