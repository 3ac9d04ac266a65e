"""Plain PyTorch pieces of nnU-Net's U-Nets, for the benchmark's references
(`nets/<family>.py:forward`): float32 with TF32 off, the store's weight
layouts, the conv -> instance norm -> LeakyReLU block, and the control's
float8 rounding. No kernel of the port, no packing and no caching.

Leaves use the store's layout: a conv weight is (kx, ky, kz, c_in, c_out),
the transposed conv's (kx, ky, kz, c_out, c_in).

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


def conv_block(h, p, stride, eps, slope, fp8):
    """Conv3d (same padding) -> InstanceNorm3d(affine, eps) -> LeakyReLU(slope)
    of the leaves `p` (`w`, `b`, `norm_scale`, `norm_bias`)."""
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
