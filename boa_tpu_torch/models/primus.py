"""Primus: a pure-transformer 3D segmentation network (a ViT encoder and a
transposed-conv voxel head).

Counterpart of `boa_tpu/models/primus.py` (`PrimusConfig`,
`PRIMUS_VARIANTS`, `primus_config`, `init_primus`, `primus_forward`;
nnU-Net's Primus trainers, `primus/primus_trainers.py:18-260`): a
patch-embedding conv tokenizes the volume, a learned position embedding
(resized when the token grid differs from the one it was made for) is
added, pre-norm blocks of attention and a GELU MLP follow, and a transposed
conv with stride = kernel = patch maps the tokens back to voxels.

The network takes (N, X, Y, Z, C) and returns (N, X, Y, Z, num_classes), as
the U-Net does; inside it runs torch's NCDHW layout with `Conv3d`,
`ConvTranspose3d` and `Linear` weights. The arithmetic follows the
reference's order and dtypes: layer-norm statistics in float32 (eps 1e-6),
qkv, the logits and their scale in the compute dtype, the softmax in
float32 cast back before the second product, GELU with the tanh
approximation (`jax.nn.gelu`'s default). Attention is the plain sequence
matmul, softmax, matmul: no fused-attention library, which the reference
does not have either.

The reference's parameter pytree (numpy, `(px, py, pz, c, d)` embed kernel,
`(d, 3d)` dense weights, `(px, py, pz, d, classes)` head kernel) comes in
through `primus_params_from_numpy` and goes back through
`weights/convert.py:params_to_numpy` (both by `param_codecs`). Its head is `jax.lax.conv_transpose` without
`transpose_kernel`, which correlates with the kernel flipped in x, y and z
against torch's `ConvTranspose3d`: the carry-across flips it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from boa_tpu_torch.device import resolve_device


@dataclass(frozen=True)
class PrimusConfig:
    embed_dim: int
    depth: int
    num_heads: int
    patch_size: tuple[int, int, int]
    num_classes: int
    input_channels: int = 1
    mlp_ratio: float = 4.0
    eps: float = 1e-6

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads


# the published Primus family (S/B/M/L)
PRIMUS_VARIANTS = {
    "S": dict(embed_dim=396, depth=12, num_heads=6),
    "B": dict(embed_dim=792, depth=12, num_heads=12),
    "M": dict(embed_dim=864, depth=16, num_heads=12),
    "L": dict(embed_dim=1056, depth=24, num_heads=16),
}


def primus_config(variant: str, num_classes: int,
                  patch_size: tuple[int, int, int] = (8, 8, 8),
                  input_channels: int = 1) -> PrimusConfig:
    v = PRIMUS_VARIANTS[variant]
    return PrimusConfig(patch_size=tuple(patch_size), num_classes=num_classes,
                        input_channels=input_channels, **v)


def init_primus(seed: int, cfg: PrimusConfig, grid: tuple[int, int, int]) -> dict:
    """A parameter pytree in the reference's layout and distributions (its
    `init_primus(key, cfg, grid)`), drawn with numpy from `seed` in place of
    a JAX key: dense kernels N(0, 1/fan_in),
    the position embedding N(0, 0.02^2) on the token `grid`, zero biases,
    unit norm scales."""
    rng = np.random.default_rng(seed)
    d = cfg.embed_dim
    px, py, pz = cfg.patch_size
    h = int(cfg.mlp_ratio * d)

    def dense(fan_in, shape):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(fan_in ** -0.5)

    def zeros(n):
        return np.zeros((n,), np.float32)

    params = {
        "embed_w": dense(px * py * pz * cfg.input_channels,
                         (px, py, pz, cfg.input_channels, d)),
        "embed_b": zeros(d),
        "pos": rng.standard_normal((*grid, d), dtype=np.float32) * np.float32(0.02),
        "blocks": [],
        "out_norm_scale": np.ones((d,), np.float32),
        "out_norm_bias": zeros(d),
        "head_w": dense(d, (px, py, pz, d, cfg.num_classes)),
        "head_b": zeros(cfg.num_classes),
    }
    for _ in range(cfg.depth):
        params["blocks"].append({
            "ln1_scale": np.ones((d,), np.float32), "ln1_bias": zeros(d),
            "qkv_w": dense(d, (d, 3 * d)), "qkv_b": zeros(3 * d),
            "proj_w": dense(d, (d, d)), "proj_b": zeros(d),
            "ln2_scale": np.ones((d,), np.float32), "ln2_bias": zeros(d),
            "mlp_w1": dense(d, (d, h)), "mlp_b1": zeros(h),
            "mlp_w2": dense(h, (h, d)), "mlp_b2": zeros(d),
        })
    return params


def resize_weights(n_in: int, n_out: int, device=None) -> torch.Tensor:
    """(n_in, n_out) weights of `jax.image.resize(..., "trilinear")` along one
    axis, antialias on (its default): half-pixel sample positions, the
    triangle kernel widened by the scale when downsampling, each column
    normalized by its sum, float32 as jax computes them."""
    inv = torch.tensor(1.0 / (n_out / n_in), dtype=torch.float32)
    kernel_scale = torch.clamp(inv, min=1.0)
    sample = (torch.arange(n_out, dtype=torch.float32) + 0.5) * inv - 0.5
    x = (sample[None, :] - torch.arange(n_in, dtype=torch.float32)[:, None]).abs() / kernel_scale
    w = torch.clamp(1.0 - x, min=0.0)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w)).to(device)


def resize_pos(pos: torch.Tensor, grid: tuple[int, int, int]) -> torch.Tensor:
    """The (gx, gy, gz, d) position embedding resized to `grid` as
    `jax.image.resize(pos, (*grid, d), "trilinear")` does: one weight matrix
    per axis whose extent changes, in the embedding's dtype."""
    out = pos
    for ax, n in enumerate(grid):
        m = out.shape[ax]
        if m == n:
            continue
        w = resize_weights(m, n, pos.device).to(pos.dtype)
        out = torch.movedim(torch.tensordot(out, w, dims=([ax], [0])), -1, ax)
    return out


def _layernorm(x: torch.Tensor, ln: nn.LayerNorm, eps: float) -> torch.Tensor:
    # float32 statistics (biased variance), the affine applied in float32 on
    # the parameters' values, rounded back to the activations' dtype once
    xf = x.float()
    m = xf.mean(-1, keepdim=True)
    v = (xf - m).square().mean(-1, keepdim=True)
    y = (xf - m) * torch.rsqrt(v + eps) * ln.weight.float() + ln.bias.float()
    return y.to(x.dtype)


class PrimusBlock(nn.Module):
    """Pre-norm transformer block: x + attn(ln1(x)), then x + mlp(ln2(x))."""

    def __init__(self, cfg: PrimusConfig, device=None):
        super().__init__()
        d = cfg.embed_dim
        h = int(cfg.mlp_ratio * d)
        self.cfg = cfg
        self.ln1 = nn.LayerNorm(d, eps=cfg.eps, device=device)
        self.qkv = nn.Linear(d, 3 * d, device=device)
        self.proj = nn.Linear(d, d, device=device)
        self.ln2 = nn.LayerNorm(d, eps=cfg.eps, device=device)
        self.mlp1 = nn.Linear(d, h, device=device)
        self.mlp2 = nn.Linear(h, d, device=device)

    def attention(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        n, t, d = x.shape
        qkv = F.linear(x, self.qkv.weight, self.qkv.bias)
        qkv = qkv.reshape(n, t, 3, cfg.num_heads, cfg.head_dim)
        # (n, t, heads, hd) -> (n, heads, t, hd)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        logits = (q @ k.transpose(-1, -2)) * (cfg.head_dim ** -0.5)
        attn = torch.softmax(logits.float(), dim=-1).to(x.dtype)
        out = (attn @ v).transpose(1, 2).reshape(n, t, d)
        return F.linear(out, self.proj.weight, self.proj.bias)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        eps = self.cfg.eps
        h = h + self.attention(_layernorm(h, self.ln1, eps))
        z = _layernorm(h, self.ln2, eps)
        z = F.gelu(F.linear(z, self.mlp1.weight, self.mlp1.bias), approximate="tanh")
        return h + F.linear(z, self.mlp2.weight, self.mlp2.bias)


class Primus(nn.Module):
    """The Primus network on `device` (default the card); `grid` is the token
    grid its position embedding is made for."""

    def __init__(self, cfg: PrimusConfig, grid: tuple[int, int, int] = (4, 4, 4),
                 device=None):
        super().__init__()
        device = resolve_device(device)
        d = cfg.embed_dim
        self.cfg = cfg
        self.embed = nn.Conv3d(cfg.input_channels, d, cfg.patch_size, cfg.patch_size,
                               device=device)
        self.pos = nn.Parameter(torch.zeros((*grid, d), device=device))
        self.blocks = nn.ModuleList(PrimusBlock(cfg, device) for _ in range(cfg.depth))
        self.out_norm = nn.LayerNorm(d, eps=cfg.eps, device=device)
        self.head = nn.ConvTranspose3d(d, cfg.num_classes, cfg.patch_size, cfg.patch_size,
                                       device=device)

    def forward(self, x: torch.Tensor, all_heads: bool = False) -> torch.Tensor:
        """(N, X, Y, Z, C) -> logits (N, X, Y, Z, num_classes); X, Y and Z
        multiples of the patch. One head: `all_heads` changes nothing."""
        n = x.shape[0]
        d = self.cfg.embed_dim
        tok = self.embed(x.permute(0, 4, 1, 2, 3))          # (n, d, gx, gy, gz)
        grid = tuple(tok.shape[2:])
        pos = self.pos if tuple(self.pos.shape[:3]) == grid else resize_pos(self.pos, grid)
        h = tok.permute(0, 2, 3, 4, 1) + pos.to(tok.dtype)
        h = h.reshape(n, math.prod(grid), d)
        for blk in self.blocks:
            h = blk(h)
        h = _layernorm(h, self.out_norm, self.cfg.eps)
        h = h.reshape(n, *grid, d).permute(0, 4, 1, 2, 3)
        return self.head(h).permute(0, 2, 3, 4, 1)


# ---------------------------------------------------------------------------
# the reference's pytree <-> the module
# ---------------------------------------------------------------------------

def _dense_to(a) -> torch.Tensor:        # (in, out) -> Linear's (out, in)
    return torch.tensor(np.asarray(a, np.float32)).t()


def _dense_from(t: torch.Tensor) -> np.ndarray:
    return t.t()


def _embed_to(a) -> torch.Tensor:        # (px, py, pz, c, d) -> (d, c, px, py, pz)
    return torch.tensor(np.asarray(a, np.float32)).permute(4, 3, 0, 1, 2)


def _embed_from(t: torch.Tensor):
    return t.permute(2, 3, 4, 1, 0)


def _head_to(a) -> torch.Tensor:         # (px, py, pz, d, k), flipped -> (d, k, px, py, pz)
    return torch.tensor(np.asarray(a, np.float32)).flip(0, 1, 2).permute(3, 4, 0, 1, 2)


def _head_from(t: torch.Tensor):
    return t.permute(2, 3, 4, 0, 1).flip(0, 1, 2)


def _same_to(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32))


def _same_from(t: torch.Tensor):
    return t


def param_codecs(model: Primus) -> list[tuple]:
    """(path in the reference's pytree, parameter, to numpy, from numpy) for
    every parameter. `to numpy` takes any tensor shaped like the parameter
    (its gradient, an optimizer moment) to the reference's layout as float32
    numpy; `from numpy` takes such a leaf back, onto the parameter's device
    and dtype."""

    def codec(to, frm):
        def to_numpy(t):
            return np.ascontiguousarray(frm(t.detach().float()).cpu().numpy())

        def from_numpy(a, like):
            t = to(a)
            if tuple(t.shape) != tuple(like.shape):
                raise ValueError(f"leaf of shape {tuple(t.shape)} for a parameter of "
                                 f"shape {tuple(like.shape)}")
            return t.contiguous().to(device=like.device, dtype=like.dtype)
        return to_numpy, from_numpy

    dense, same = codec(_dense_to, _dense_from), codec(_same_to, _same_from)
    out = [(("embed_w",), model.embed.weight, *codec(_embed_to, _embed_from)),
           (("embed_b",), model.embed.bias, *same),
           (("pos",), model.pos, *same)]
    for i, blk in enumerate(model.blocks):
        for name, p, c in (("ln1_scale", blk.ln1.weight, same), ("ln1_bias", blk.ln1.bias, same),
                           ("qkv_w", blk.qkv.weight, dense), ("qkv_b", blk.qkv.bias, same),
                           ("proj_w", blk.proj.weight, dense), ("proj_b", blk.proj.bias, same),
                           ("ln2_scale", blk.ln2.weight, same), ("ln2_bias", blk.ln2.bias, same),
                           ("mlp_w1", blk.mlp1.weight, dense), ("mlp_b1", blk.mlp1.bias, same),
                           ("mlp_w2", blk.mlp2.weight, dense), ("mlp_b2", blk.mlp2.bias, same)):
            out.append((("blocks", i, name), p, *c))
    out += [(("out_norm_scale",), model.out_norm.weight, *same),
            (("out_norm_bias",), model.out_norm.bias, *same),
            (("head_w",), model.head.weight, *codec(_head_to, _head_from)),
            (("head_b",), model.head.bias, *same)]
    return out


def primus_params_from_numpy(tree: dict, cfg: PrimusConfig, device=None) -> Primus:
    """The reference's Primus pytree (numpy leaves) -> the module on
    `device` (default the card); the position embedding's grid is the
    tree's."""
    from boa_tpu_torch.weights.convert import load_params_into

    grid = tuple(np.asarray(tree["pos"]).shape[:3])
    model = Primus(cfg, grid=grid, device=device)
    load_params_into(model, tree)
    return model
