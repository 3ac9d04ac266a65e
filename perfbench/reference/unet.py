"""Plain PyTorch forward of nnU-Net's PlainConvUNet, the benchmark's reference.

The network as published by dynamic_network_architectures (nnU-Net v2):
per encoder stage `n_conv` blocks of Conv3d (the first at the stage's
stride) -> InstanceNorm3d(affine, eps) -> LeakyReLU(slope); per decoder
stage a ConvTranspose3d(kernel = stride) upsampling, the concatenation
[upsampled, skip] and `n_conv` blocks; a 1x1x1 head on the last decoder
stage. Float32 with TF32 off, no kernel of the port, no packing and no
caching: `torch.nn.functional` calls on the parameter leaves as the
benchmark made them.

Leaves use the store's layout (`perfbench/weights.py`): a conv weight is
(kx, ky, kz, c_in, c_out), the transposed conv's (kx, ky, kz, c_out, c_in).

`fp8=True` is the control of PERF.md: every convolution's two operands
(activation and weight) are rounded to float8 e4m3 with a per-tensor
scale that maps the largest magnitude to 448, and the product accumulates
in float32, as an fp8 tensor-core GEMM does.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0


@contextlib.contextmanager
def exact_float32():
    """TF32 off for cuDNN and matmuls inside the block."""
    old = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = old


def round_e4m3(t: torch.Tensor) -> torch.Tensor:
    """`t` rounded to float8 e4m3 under a per-tensor scale, back in float32."""
    scale = E4M3_MAX / t.abs().amax().clamp(min=1e-30)
    return (t * scale).to(torch.float8_e4m3fn).float() / scale


def conv_weight(w: torch.Tensor) -> torch.Tensor:
    """(kx, ky, kz, ci, co) -> torch's (co, ci, kx, ky, kz)."""
    return w.permute(4, 3, 0, 1, 2).contiguous()


def transp_weight(w: torch.Tensor) -> torch.Tensor:
    """(kx, ky, kz, co, ci) -> torch's (ci, co, kx, ky, kz)."""
    return w.permute(4, 3, 0, 1, 2).contiguous()


def _block(h, p, stride, eps, slope, fp8):
    w = conv_weight(p["w"])
    if fp8:
        h, w = round_e4m3(h), round_e4m3(w)
    pad = tuple((k - 1) // 2 for k in w.shape[2:])
    y = F.conv3d(h, w, p["b"], stride=tuple(stride), padding=pad)
    mean = y.mean(dim=(2, 3, 4), keepdim=True)
    var = (y - mean).square().mean(dim=(2, 3, 4), keepdim=True)
    y = (y - mean) * torch.rsqrt(var + eps)
    y = y * p["norm_scale"].view(1, -1, 1, 1, 1) + p["norm_bias"].view(1, -1, 1, 1, 1)
    return torch.where(y >= 0, y, y * slope)


@torch.no_grad()
def forward(params: dict, net: dict, x: torch.Tensor, fp8: bool = False) -> torch.Tensor:
    """(N, C, X, Y, Z) float32 -> logits (N, classes, X, Y, Z) float32.

    `net` holds the configuration's network keys (`strides`, `norm_eps`,
    `nonlin_slope`); `params` the leaves as float32 tensors on x's device."""
    eps, slope = float(net["norm_eps"]), float(net["nonlin_slope"])
    strides = net["strides"]
    skips = []
    h = x.float()
    for s, stage in enumerate(params["encoder"]):
        for b, blk in enumerate(stage):
            h = _block(h, blk, strides[s] if b == 0 else (1, 1, 1), eps, slope, fp8)
        skips.append(h)
    y = skips[-1]
    n = len(skips)
    for i, st in enumerate(params["decoder"]):
        w = transp_weight(st["transp"]["w"])
        up_in = y
        if fp8:
            up_in, w = round_e4m3(up_in), round_e4m3(w)
        stride = tuple(strides[n - 1 - i])
        y = F.conv_transpose3d(up_in, w, st["transp"]["b"], stride=stride)
        y = torch.cat([y, skips[n - 2 - i]], dim=1)
        for blk in st["convs"]:
            y = _block(y, blk, (1, 1, 1), eps, slope, fp8)
    head = params["seg_heads"][-1]
    w = conv_weight(head["w"])
    if fp8:
        y, w = round_e4m3(y), round_e4m3(w)
    return F.conv3d(y, w, head["b"])
