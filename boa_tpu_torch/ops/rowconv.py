"""Row-conv family on Hopper: fused conv + input norm/act + sums, stride-2
conv, and the 2x2x2 transposed conv.

Counterpart of `boa_tpu/ops/rowconv.py`. The Pallas kernels there
(`_rowconv_kernel`, `_rowconv_g4_kernel`, `_stride2_kernel`,
`_transp_kernel`) compute on a TPU lane layout (Z, X, C, Y); here the public
functions keep the JAX package's channels-last layout instead:
activations (N, X, Y, Z, C), conv weights (kx, ky, kz, ci, co).

Each public function is a kernel wrapper. A CPU tensor takes the plain
PyTorch version beside it (same contract, same bf16 rounding points); a CUDA
tensor launches the hand-written CUDA kernel of `csrc/` or raises. Each
launch adds one to `LAUNCHES[name]`.

  conv3d_rows          csrc/rowconv.cu, stride 1  (K1 and K4)
  conv3d_rows_stride2  csrc/rowconv.cu, stride 2  (K2)
  transpconv2_rows     csrc/transpconv.cu         (K3)
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F

from boa_tpu_torch.ops.pallas_conv import (NormAct, identity_normact,  # noqa: F401
                                           stats_from_sums)

#: kernel launches per wrapper since the last `reset_launches()`
LAUNCHES: dict[str, int] = {"conv3d_rows": 0, "conv3d_rows_stride2": 0,
                            "transpconv2_rows": 0}

_CONV_COUT = (16, 32, 64)
_TRANSP_COUT = (8, 16, 32, 64)
#: the widest cout the conv kernel takes (the composite forward checks it)
CONV_MAX_COUT = _CONV_COUT[-1]


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def _norm_rows(norm: NormAct, slope, n: int, cin: int, cin_p: int,
               device) -> torch.Tensor:
    """(N, 4, cin_p) float32 rows [mean, inv_std*gamma, beta, slope]; padded
    channels get scale 0 (their activation is 0) and slope 1."""
    def per(v):
        v = torch.as_tensor(v, dtype=torch.float32, device=device)
        return torch.broadcast_to(v, (n, cin))

    scale = per(norm.inv_std) * per(norm.gamma)
    rows = torch.zeros((n, 4, cin_p), dtype=torch.float32, device=device)
    rows[:, 3] = 1.0
    rows[:, 0, :cin] = per(norm.mean)
    rows[:, 1, :cin] = scale
    rows[:, 2, :cin] = per(norm.beta)
    rows[:, 3, :cin] = per(slope)
    return rows


def _bias(b, cout: int, device) -> torch.Tensor:
    if b is None:
        return torch.zeros(cout, dtype=torch.float32, device=device)
    return b.to(device=device, dtype=torch.float32)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _conv_plain(x, norm, w, b, slope, stride, out_dtype):
    n, _, _, _, cin = x.shape
    rows = _norm_rows(norm, slope, n, cin, cin, x.device)[:, :, None, None, None]
    xf = x.to(torch.bfloat16).float()  # the reference casts x before the norm
    xn = (xf - rows[:, 0]) * rows[:, 1] + rows[:, 2]
    xn = torch.where(xn >= 0, xn, xn * rows[:, 3])
    xn = xn.to(torch.bfloat16).float()
    wt = w.to(torch.bfloat16).float().permute(4, 3, 0, 1, 2)
    y = F.conv3d(xn.permute(0, 4, 1, 2, 3), wt, stride=stride, padding=1)
    y = y + _bias(b, w.shape[-1], x.device)[None, :, None, None, None]
    sums = torch.stack([y.sum((2, 3, 4)), (y * y).sum((2, 3, 4))], dim=1)
    return y.permute(0, 2, 3, 4, 1).to(out_dtype).contiguous(), sums


def conv3d_rows_plain(x, norm, w, b, *, slope=1.0, out_dtype=torch.bfloat16):
    return _conv_plain(x, norm, w, b, slope, 1, out_dtype)


def conv3d_rows_stride2_plain(x, norm, w, b, *, slope=1.0,
                              out_dtype=torch.bfloat16):
    return _conv_plain(x, norm, w, b, slope, 2, out_dtype)


def transpconv2_rows_plain(x, w, *, out_dtype=torch.bfloat16):
    n, X, Y, Z, _ = x.shape
    out = torch.einsum("nxyzi,abcio->nxaybzco", x.to(torch.bfloat16).float(),
                       w.to(torch.bfloat16).float())
    return out.reshape(n, 2 * X, 2 * Y, 2 * Z, w.shape[-1]).to(out_dtype)


# ---------------------------------------------------------------------------
# kernel launches
# ---------------------------------------------------------------------------


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _out_f32(out_dtype) -> int:
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"out_dtype {out_dtype} not supported by the kernel")
    return int(out_dtype == torch.float32)


def pack_conv_weights(w: torch.Tensor, cin_k: int, cout_p: int) -> torch.Tensor:
    """(3, 3, 3, cin, cout) -> the conv kernel's B fragments, bf16, zero
    padded to (cin_k, cout_p): for tap (dx*3 + dy)*3 + dz, k chunk kc, column
    pair p and lane 4g + t, the eight values w[tap, kc*16 + 8h + 2t + e,
    p*16 + 8q + g] in (q, h, e) order, i.e. the two m16n8k16 B registers of
    two n8 tiles, in the order the lane holds them."""
    cin, cout = w.shape[3], w.shape[4]
    wq = F.pad(w.to(torch.bfloat16), (0, cout_p - cout, 0, cin_k - cin))
    #                  tap  kc          h  t  e  p             q  g
    wq = wq.reshape(27, cin_k // 16, 2, 4, 2, cout_p // 16, 2, 8)
    return wq.permute(0, 1, 5, 7, 3, 6, 2, 4).contiguous()


def _conv_kernel(x, norm, w, b, slope, stride, out_dtype, name):
    from boa_tpu_torch import _build

    if x.dtype != torch.bfloat16 or x.dim() != 5:
        raise ValueError(f"{name}: needs a bf16 (N, X, Y, Z, C) tensor, got "
                         f"{x.dtype} {tuple(x.shape)}")
    if tuple(w.shape[:3]) != (3, 3, 3) or w.shape[3] != x.shape[-1]:
        raise ValueError(f"{name}: weight {tuple(w.shape)} does not fit "
                         f"input {tuple(x.shape)}")
    n, X, Y, Z, cin = x.shape
    cout = int(w.shape[-1])
    cout_p = next((c for c in _CONV_COUT if c >= cout), None)
    if cout_p is None:
        raise ValueError(f"{name}: cout {cout} > {CONV_MAX_COUT}")
    dev = x.device
    x = x.contiguous()
    cin_k = _round_up(cin, 16)   # the kernel zero-fills channels past cin
    wp = pack_conv_weights(w.to(dev), cin_k, cout_p)
    bias = torch.zeros(cout_p, dtype=torch.float32, device=dev)
    bias[:cout] = _bias(b, cout, dev)
    rows = _norm_rows(norm, slope, n, cin, cin_k, dev)
    Xo, Yo, Zo = ((v - 1) // stride + 1 for v in (X, Y, Z))
    y = torch.empty((n, Xo, Yo, Zo, cout_p), dtype=out_dtype, device=dev)
    sums = torch.zeros((n, 2, cout_p), dtype=torch.float32, device=dev)
    err = _build.lib("rowconv").boa_rowconv_fwd(
        x.data_ptr(), rows.data_ptr(), wp.data_ptr(), bias.data_ptr(),
        y.data_ptr(), sums.data_ptr(), n, X, Y, Z, cin, cin_k, cout_p, stride,
        _out_f32(out_dtype), _stream())
    _build.check(err, name)
    LAUNCHES[name] += 1
    if cout_p != cout:
        y, sums = y[..., :cout], sums[..., :cout]
    return y, sums


def _transp_kernel(x, w, out_dtype):
    from boa_tpu_torch import _build

    if x.dtype != torch.bfloat16 or x.dim() != 5:
        raise ValueError("transpconv2_rows: needs a bf16 (N, X, Y, Z, C) "
                         f"tensor, got {x.dtype} {tuple(x.shape)}")
    if tuple(w.shape[:3]) != (2, 2, 2) or w.shape[3] != x.shape[-1]:
        raise ValueError(f"transpconv2_rows: weight {tuple(w.shape)} does "
                         f"not fit input {tuple(x.shape)}")
    n, X, Y, Z, cin = x.shape
    cout = int(w.shape[-1])
    cout_p = next((c for c in _TRANSP_COUT if c >= cout), None)
    if cout_p is None:
        raise ValueError(f"transpconv2_rows: cout {cout} > {_TRANSP_COUT[-1]}")
    dev = x.device
    cin_p = _round_up(cin, 16)
    if cin_p != cin:
        x = F.pad(x, (0, cin_p - cin))
    x = x.contiguous()
    wq = F.pad(w.to(device=dev, dtype=torch.bfloat16),
               (0, cout_p - cout, 0, cin_p - cin))  # (a, b, c, ci, co)
    wp = wq.permute(0, 1, 3, 2, 4).reshape(4, cin_p, 2 * cout_p).contiguous()
    y = torch.empty((n, 2 * X, 2 * Y, 2 * Z, cout_p), dtype=out_dtype,
                    device=dev)
    err = _build.lib("transpconv").boa_transpconv2_fwd(
        x.data_ptr(), wp.data_ptr(), y.data_ptr(), n, X, Y, Z, cin_p, cout_p,
        _out_f32(out_dtype), _stream())
    _build.check(err, "transpconv2_rows")
    LAUNCHES["transpconv2_rows"] += 1
    return y[..., :cout] if cout_p != cout else y


def _route(x: torch.Tensor) -> bool:
    """True: launch the kernel (CUDA tensor); False: plain version (CPU)."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {x.device}")


# ---------------------------------------------------------------------------
# public wrappers
# ---------------------------------------------------------------------------


def conv3d_rows(x: torch.Tensor, norm: NormAct, w: torch.Tensor,
                b: torch.Tensor | None, *, slope=1.0,
                out_dtype=torch.bfloat16):
    """y = conv3d(act(x), w, stride 1, 'same') + b, plus per-sample sums.

    x: (N, X, Y, Z, cin) raw activations (`norm` carries x's own IN tail,
    identity for the network input); w: (3, 3, 3, cin, cout); slope: scalar
    or (cin,) LeakyReLU slope of act. Returns (y (N, X, Y, Z, cout),
    sums (N, 2, cout) float32 = [sum y, sum y^2] from the fp32 values)."""
    if _route(x):
        return _conv_kernel(x, norm, w, b, slope, 1, out_dtype, "conv3d_rows")
    return conv3d_rows_plain(x, norm, w, b, slope=slope, out_dtype=out_dtype)


def conv3d_rows_stride2(x: torch.Tensor, norm: NormAct, w: torch.Tensor,
                        b: torch.Tensor | None, *, slope=1.0,
                        out_dtype=torch.bfloat16):
    """`conv3d_rows` at stride 2, padding 1: out[o] = sum_d w[d] act(x)[2o+d-1]
    (torch Conv3d(stride=2, padding=1)); output extents ceil(n/2)."""
    if _route(x):
        return _conv_kernel(x, norm, w, b, slope, 2, out_dtype,
                            "conv3d_rows_stride2")
    return conv3d_rows_stride2_plain(x, norm, w, b, slope=slope,
                                     out_dtype=out_dtype)


def transpconv2_rows(x: torch.Tensor, w: torch.Tensor, *,
                     out_dtype=torch.bfloat16) -> torch.Tensor:
    """2x2x2 stride-2 transposed conv, no bias (the caller adds it):
    out[n, 2x+a, 2y+b, 2z+c, co] = sum_ci x[n, x, y, z, ci] w[a, b, c, ci, co]."""
    if _route(x):
        return _transp_kernel(x, w, out_dtype)
    return transpconv2_rows_plain(x, w, out_dtype=out_dtype)


class RowOps(NamedTuple):
    """The three functions the composite forward calls."""

    conv3d_rows: Callable
    conv3d_rows_stride2: Callable
    transpconv2_rows: Callable


#: the wrappers (kernels on the card, plain versions on the CPU)
KERNELS = RowOps(conv3d_rows, conv3d_rows_stride2, transpconv2_rows)
#: the plain versions on any device: the yardstick for the kernels
PLAIN = RowOps(conv3d_rows_plain, conv3d_rows_stride2_plain,
               transpconv2_rows_plain)
