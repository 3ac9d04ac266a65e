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
port's network (`models/unet.py:make_unet`) and `params_to_numpy` turns it
back, through `param_leaves`, which names each parameter's path in the
pytree (the trainer's optimizer-state carry uses it too). (X, Y, Z) stays
torch's (D, H, W), so only the channel axes move.

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
from boa_tpu_torch.models.unet import ArchConfig, ConvBlock, PlainConvUNet, make_unet


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


def _block_leaves(blk: ConvBlock, path: tuple) -> list:
    out = [(path + ("w",), blk.conv.weight)]
    if blk.conv.bias is not None:
        out.append((path + ("b",), blk.conv.bias))
    if blk.norm.weight is not None:
        out.append((path + ("norm_scale",), blk.norm.weight))
    if blk.norm.bias is not None:
        out.append((path + ("norm_bias",), blk.norm.bias))
    return out


def param_leaves(model: PlainConvUNet) -> list[tuple[tuple, torch.nn.Parameter]]:
    """Every parameter of the network with its path in the reference's
    pytree (``("encoder", s, b, "w")``, ``("decoder", i, "transp", "b")``,
    ...). Weights are stored torch-major; `params_to_numpy` and the
    optimizer-state carry (`train/optim.py`) move their axes with
    `kernel_to_numpy`. Every leaf of the pytree appears exactly once."""
    out: list = []
    if model.cfg.residual_encoder:
        out += _block_leaves(model.stem, ("stem",))
    for s, stage in enumerate(model.encoder):
        for b, blk in enumerate(stage):
            if model.cfg.residual_encoder:
                for part in ("conv1", "conv2", "skip"):
                    if getattr(blk, part) is not None:
                        out += _block_leaves(getattr(blk, part), ("encoder", s, b, part))
            else:
                out += _block_leaves(blk, ("encoder", s, b))
    for i, st in enumerate(model.decoder):
        out += [(("decoder", i, "transp", "w"), st.transp.weight),
                (("decoder", i, "transp", "b"), st.transp.bias)]
        for b, blk in enumerate(st.convs):
            out += _block_leaves(blk, ("decoder", i, "convs", b))
    for i, head in enumerate(model.seg_heads):
        out += [(("seg_heads", i, "w"), head.weight), (("seg_heads", i, "b"), head.bias)]
    return out


def kernel_to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor shaped like a parameter -> its leaf in the reference's layout
    (conv weights (co, ci, k...) -> (k..., ci, co), the transposed conv's
    (ci, co, k...) -> (k..., co, ci): one permutation), as float32 numpy."""
    t = t.detach().float()
    if t.dim() == 5:
        t = t.permute(2, 3, 4, 1, 0)
    return np.ascontiguousarray(t.cpu().numpy())


def kernel_from_numpy(a, like: torch.Tensor) -> torch.Tensor:
    """The inverse of `kernel_to_numpy`, on `like`'s device and dtype."""
    t = torch.tensor(np.asarray(a), dtype=torch.float32)
    if t.dim() == 5:
        t = t.permute(4, 3, 0, 1, 2)
    if tuple(t.shape) != tuple(like.shape):
        raise ValueError(f"leaf of shape {tuple(t.shape)} for a parameter of "
                         f"shape {tuple(like.shape)}")
    return t.contiguous().to(device=like.device, dtype=like.dtype)


def tree_set(tree: dict, path: tuple, value) -> None:
    """Set `tree[path]`, creating the dicts and lists on the way (a list
    index is appended in order, as `param_leaves` visits them)."""
    node: Any = tree
    for key, nxt in zip(path[:-1], path[1:]):
        empty = [] if isinstance(nxt, int) else {}
        if isinstance(node, list):
            if len(node) == key:
                node.append(empty)
            node = node[key]
        else:
            node = node.setdefault(key, empty)
    if isinstance(node, list):
        node.append(value)
    else:
        node[path[-1]] = value


def tree_get(tree, path: tuple):
    for key in path:
        tree = tree[key]
    return tree


def param_codecs(model) -> list[tuple]:
    """(path, parameter, to numpy, from numpy) for every parameter of a
    network of the port: `param_leaves` with `kernel_to_numpy` /
    `kernel_from_numpy` for the U-Net families, the Primus module's own
    (`models/primus.py:param_codecs`, whose dense and head kernels move
    otherwise)."""
    from boa_tpu_torch.models.primus import Primus, param_codecs as primus_codecs

    if isinstance(model, Primus):
        return primus_codecs(model)
    return [(path, p, kernel_to_numpy, kernel_from_numpy) for path, p in param_leaves(model)]


def params_to_numpy(model) -> dict:
    """The network's parameters as the reference's pytree of float32 numpy
    arrays: the inverse of `params_from_numpy`, so a checkpoint the port
    writes loads in the reference and back."""
    tree: dict = {}
    for path, p, to_np, _ in param_codecs(model):
        tree_set(tree, path, to_np(p))
    return tree


@torch.no_grad()
def load_params_into(model, params_np: dict) -> None:
    """Copy the reference's parameter pytree into the network in place. The
    tree's leaves must be exactly the network's parameters (`param_codecs`),
    else ValueError."""
    leaves = param_codecs(model)
    have: dict[str, np.ndarray] = {}
    _flatten(params_np, "", have)
    want = {"/".join(map(str, path)) for path, *_ in leaves}
    if set(have) != want:
        raise ValueError(
            f"parameter tree does not fit the network: missing "
            f"{sorted(want - set(have))[:8]}, unexpected {sorted(set(have) - want)[:8]}")
    for path, p, _, from_np in leaves:
        p.copy_(from_np(have["/".join(map(str, path))], p))


def params_from_numpy(params_np: dict, cfg: ArchConfig, device=None) -> PlainConvUNet:
    """The reference's parameter pytree (numpy leaves) -> the network of
    `cfg`'s family (PlainConvUNet or ResidualEncoderUNet) on `device`
    (default the card). Deep supervision shares the plain layout: one head
    per decoder stage."""
    model = make_unet(cfg, device=resolve_device(device))
    load_params_into(model, params_np)
    return model.eval()
