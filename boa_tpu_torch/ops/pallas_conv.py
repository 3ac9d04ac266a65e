"""Input-side normalization record and instance-norm statistics.

Counterpart of `boa_tpu/ops/pallas_conv.py` (`NormAct`, `identity_normact`,
`stats_from_sums`). The z-packed conv kernel of that module is still to be
ported (PERF.md kernel table, K5); the row-conv kernels of `ops/rowconv.py`
use these helpers.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class NormAct(NamedTuple):
    """Input-side normalization+activation (the previous layer's IN tail).

    Each field is (C,) or, with per-sample statistics, (N, C)."""

    mean: torch.Tensor
    inv_std: torch.Tensor  # 1/sqrt(var+eps)
    gamma: torch.Tensor    # affine scale (ones if not affine)
    beta: torch.Tensor     # affine bias
    slope: float           # LeakyReLU negative slope; 1.0 = no activation


def identity_normact(c: int, device=None) -> NormAct:
    kw = dict(dtype=torch.float32, device=device)
    return NormAct(torch.zeros(c, **kw), torch.ones(c, **kw),
                   torch.ones(c, **kw), torch.zeros(c, **kw), 1.0)


def stats_from_sums(sums: torch.Tensor, count: int, eps: float = 1e-5):
    """(mean, inv_std) from (..., 2, C) [sum y, sum y^2] over `count` voxels.

    The same E[y^2] - E[y]^2 formula as the reference, clipped at 0."""
    mean = sums[..., 0, :] / count
    var = torch.clamp(sums[..., 1, :] / count - mean * mean, min=0.0)
    return mean, torch.rsqrt(var + eps)
