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

  conv3d_rows          csrc/conv_in_act.cu  (K1 and K4, on K5's kernel)
  conv3d_rows_stride2  csrc/stride2conv.cu  (K2)
  transpconv2_rows     csrc/transpconv.cu   (K3)

`conv3d_rows` runs the batched form of the wide-channel conv kernel of
`ops/pallas_conv.py`; a call too small to fill the card is split over K
and also launches that kernel's finishing pass, counted in
`LAUNCHES["conv3d_rows_finish"]`. Weights are packed for their wrapper's
kernel by `pack_rows` / `pack_conv` / `pack_transp` into a `Packed` (B
fragments plus the fp32 bias); a caller that runs a layer many
times packs once and passes `w_packed`. `out=` takes a channels-last view
whose voxels are evenly spaced (a channel slice of a wider buffer, such as
the decoder concat), and the result is written there. `prepare_launch`
returns a wrapper's launch apart from its preparation, for timing.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F

from boa_tpu_torch.ops import pallas_conv as pc
from boa_tpu_torch.ops.pallas_conv import (  # noqa: F401
    NormAct, _bias, _conv_plain, _norm_rows, _out_f32, _round_up, _route,
    _stream, identity_normact, stats_from_sums)

#: kernel launches per wrapper since the last `reset_launches()`
LAUNCHES: dict[str, int] = {"conv3d_rows": 0, "conv3d_rows_finish": 0,
                            "conv3d_rows_stride2": 0, "transpconv2_rows": 0}

_CONV_COUT = (16, 32, 64)
_TRANSP_COUT = (8, 16, 32, 64)
#: the widest cout the stride-2 kernel takes (the composite forward checks it)
CONV_MAX_COUT = _CONV_COUT[-1]


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# packed weights
# ---------------------------------------------------------------------------


class Packed(NamedTuple):
    """One layer's weights in its kernel's order, made once per parameter."""

    w: torch.Tensor     # B fragments, bf16, in the order of `kind`'s kernel
    bias: torch.Tensor  # (cout_p,) float32, zero past cout
    cin: int
    cout: int
    kind: str           # the wrapper whose kernel reads them


def _fragments(wk: torch.Tensor) -> torch.Tensor:
    """(T, K, N) bf16, K and N multiples of 16 -> the m16n8k16 B fragments:
    for tap t, k chunk kc, column pair p and lane 4g + t', the eight values
    w[t, kc*16 + 8h + 2t' + e, p*16 + 8q + g] in (q, h, e) order, i.e. the
    two B registers of two n8 tiles, in the order the lane holds them."""
    T, K, N = wk.shape
    #                  tap kc      h  t  e  p        q  g
    wq = wk.reshape(T, K // 16, 2, 4, 2, N // 16, 2, 8)
    return wq.permute(0, 1, 5, 7, 3, 6, 2, 4).contiguous()


def _unfragments(pk: torch.Tensor, T: int, K: int, N: int) -> torch.Tensor:
    """Inverse of `_fragments`: (T, K, N)."""
    #                   tap kc       p        g  t  q  h  e
    w = pk.reshape(T, K // 16, N // 16, 8, 4, 2, 2, 2)
    return w.permute(0, 1, 6, 4, 7, 2, 5, 3).reshape(T, K, N)


def _padded_bias(b, cout: int, cout_p: int, device) -> torch.Tensor:
    bias = torch.zeros(cout_p, dtype=torch.float32, device=device)
    bias[:cout] = _bias(b, cout, device)
    return bias


def pack_conv_weights(w: torch.Tensor, cin_k: int, cout_p: int) -> torch.Tensor:
    """(3, 3, 3, cin, cout) -> the conv kernels' B fragments, bf16, zero
    padded to (cin_k, cout_p), tap (dx*3 + dy)*3 + dz (see `_fragments`)."""
    cin, cout = w.shape[3], w.shape[4]
    wq = F.pad(w.to(torch.bfloat16), (0, cout_p - cout, 0, cin_k - cin))
    return _fragments(wq.reshape(27, cin_k, cout_p))


def _conv_shape(what: str, w: torch.Tensor) -> tuple[int, int]:
    if w.dim() != 5 or tuple(w.shape[:3]) != (3, 3, 3):
        raise ValueError(f"{what}: weight {tuple(w.shape)} is not 3x3x3")
    return int(w.shape[3]), int(w.shape[4])


def _rows_plan(cin: int, cout: int) -> tuple[int, int, int, int]:
    """(ck, nchunks, bn, cout_p) of a `conv3d_rows` call: K5's plan, with
    the 27 taps folded into K for a 1-channel input."""
    return pc._plan(cin, cout, fold=cin == 1)


@torch.no_grad()
def pack_rows(w: torch.Tensor, b: torch.Tensor | None) -> Packed:
    """A 3x3x3 conv (w (3, 3, 3, cin, cout), b (cout,) or None) packed for
    `conv3d_rows`: the wide-channel kernel's fragments
    (`pallas_conv.pack_in_act_weights`), taps folded into K when cin = 1."""
    cin, cout = _conv_shape("pack_rows", w)
    cout_p = _rows_plan(cin, cout)[3]
    return Packed(pc.pack_in_act_weights(w, fold=cin == 1),
                  _padded_bias(b, cout, cout_p, w.device), cin, cout, "conv3d_rows")


def unpack_rows(p: Packed) -> tuple[torch.Tensor, torch.Tensor]:
    """(w (3, 3, 3, cin, cout) float32, b (cout,) float32) of `pack_rows`."""
    w = pc.unpack_in_act_weights(p.w, p.cin, p.cout, fold=p.cin == 1)
    return w.float(), p.bias[:p.cout]


@torch.no_grad()
def pack_conv(w: torch.Tensor, b: torch.Tensor | None) -> Packed:
    """A 3x3x3 conv (w (3, 3, 3, cin, cout), b (cout,) or None) packed for
    `conv3d_rows_stride2`: tap-major fragments (`pack_conv_weights`)."""
    cin, cout = _conv_shape("pack_conv", w)
    cout_p = next((c for c in _CONV_COUT if c >= cout), None)
    if cout_p is None:
        raise ValueError(f"pack_conv: cout {cout} > {CONV_MAX_COUT}")
    return Packed(pack_conv_weights(w, _round_up(cin, 16), cout_p),
                  _padded_bias(b, cout, cout_p, w.device), cin, cout,
                  "conv3d_rows_stride2")


def unpack_conv(p: Packed) -> tuple[torch.Tensor, torch.Tensor]:
    """(w (3, 3, 3, cin, cout) float32, b (cout,) float32) of a `Packed`."""
    cin_k = _round_up(p.cin, 16)
    w = _unfragments(p.w, 27, cin_k, p.bias.numel()).float()
    return w[:, :p.cin, :p.cout].reshape(3, 3, 3, p.cin, p.cout), p.bias[:p.cout]


@torch.no_grad()
def pack_transp(w: torch.Tensor, b: torch.Tensor | None) -> Packed:
    """A 2x2x2 transposed conv (w (2, 2, 2, cin, cout) with taps (a, b, c)
    along (x, y, z), b (cout,) or None) packed for `transpconv2_rows`: per
    (a, b) pair a (cin_p, 2*cout_p) matrix with columns (c, co), as B
    fragments (see `_fragments`)."""
    if w.dim() != 5 or tuple(w.shape[:3]) != (2, 2, 2):
        raise ValueError(f"pack_transp: weight {tuple(w.shape)} is not 2x2x2")
    cin, cout = int(w.shape[3]), int(w.shape[4])
    cout_p = next((c for c in _TRANSP_COUT if c >= cout), None)
    if cout_p is None:
        raise ValueError(f"pack_transp: cout {cout} > {_TRANSP_COUT[-1]}")
    cin_p = _round_up(cin, 16)
    wq = F.pad(w.to(torch.bfloat16), (0, cout_p - cout, 0, cin_p - cin))
    wk = wq.permute(0, 1, 3, 2, 4).reshape(4, cin_p, 2 * cout_p)
    return Packed(_fragments(wk), _padded_bias(b, cout, cout_p, w.device), cin, cout,
                  "transpconv2_rows")


def unpack_transp(p: Packed) -> tuple[torch.Tensor, torch.Tensor]:
    """(w (2, 2, 2, cin, cout) float32, b (cout,) float32) of a `Packed`."""
    cin_p, cout_p = _round_up(p.cin, 16), p.bias.numel()
    w = _unfragments(p.w, 4, cin_p, 2 * cout_p).reshape(2, 2, cin_p, 2, cout_p)
    w = w.permute(0, 1, 3, 2, 4).float()
    return w[..., :p.cin, :p.cout], p.bias[:p.cout]


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _into(out: torch.Tensor | None, y: torch.Tensor) -> torch.Tensor:
    if out is None:
        return y
    out.copy_(y)
    return out


def _kind(name: str, p: Packed) -> Packed:
    if p.kind != name:
        raise ValueError(f"{name}: weights packed for {p.kind}")
    return p


def _plain_conv(name, x, norm, w, b, slope, stride, out_dtype, w_packed, out):
    if w_packed is not None:
        unpack = unpack_rows if stride == 1 else unpack_conv
        w, b = unpack(_kind(name, w_packed))
    y, sums = _conv_plain(x, norm, w, b, slope, stride, out_dtype)
    return _into(out, y), sums


def conv3d_rows_plain(x, norm, w, b, *, slope=1.0, out_dtype=torch.bfloat16,
                      w_packed=None, out=None):
    return _plain_conv("conv3d_rows", x, norm, w, b, slope, 1, out_dtype, w_packed, out)


def conv3d_rows_stride2_plain(x, norm, w, b, *, slope=1.0,
                              out_dtype=torch.bfloat16, w_packed=None):
    return _plain_conv("conv3d_rows_stride2", x, norm, w, b, slope, 2, out_dtype,
                       w_packed, None)


def transpconv2_rows_plain(x, w, b=None, *, out_dtype=torch.bfloat16,
                           w_packed=None, out=None):
    """fp32 products and bias, one rounding to `out_dtype` (as the kernel)."""
    if w_packed is not None:
        w, b = unpack_transp(_kind("transpconv2_rows", w_packed))
    n, X, Y, Z, _ = x.shape
    y = torch.einsum("nxyzi,abcio->nxaybzco", x.to(torch.bfloat16).float(),
                     w.to(torch.bfloat16).float())
    y = y.reshape(n, 2 * X, 2 * Y, 2 * Z, w.shape[-1])
    if b is not None:
        y = y + b.to(device=y.device, dtype=torch.float32)
    return _into(out, y.to(out_dtype))


# ---------------------------------------------------------------------------
# kernel launches
# ---------------------------------------------------------------------------


def _voxel_stride(t: torch.Tensor) -> int | None:
    """The voxel stride of a channels-last (N, X, Y, Z, C) view whose
    channels are contiguous and whose voxels are evenly spaced (a channel
    slice of a contiguous buffer); None for any other layout."""
    n, X, Y, Z, C = t.shape
    s = t.stride()
    ld = s[3]
    dense = ((C == 1 or s[4] == 1) and ld >= C
             and (Y == 1 or s[2] == Z * ld)
             and (X == 1 or s[1] == Y * Z * ld)
             and (n == 1 or s[0] == X * Y * Z * ld))
    return ld if dense else None


def _out_buffer(out, shape, cout, cout_p, out_dtype, dev, align: int):
    """(buffer the kernel writes, its voxel stride, copy-back target): the
    kernel writes `out` itself when it is a channel slice it can address,
    else a fresh (..., cout_p) buffer that the launch copies into `out`."""
    if out is not None:
        if tuple(out.shape) != tuple(shape) + (cout,) or out.dtype != out_dtype \
                or out.device != dev:
            raise ValueError(f"out {tuple(out.shape)} {out.dtype} does not fit "
                             f"{tuple(shape) + (cout,)} {out_dtype}")
        ld = _voxel_stride(out)
        if (ld is not None and cout == cout_p and out.data_ptr() % align == 0
                and (ld * out.element_size()) % align == 0):
            return out, ld, None
    return torch.empty(tuple(shape) + (cout_p,), dtype=out_dtype, device=dev), cout_p, out


def _launcher(name: str, fn, args, keep, back=None, y=None) -> Callable[[], None]:
    """The launch of one prepared call: the kernel, its count, and the copy
    of `y` into `back` when the kernel could not write there itself. The
    launch holds `keep`, the tensors whose pointers are in `args`."""
    from boa_tpu_torch import _build

    def launch() -> None:
        _build.check(fn(*args), name)
        LAUNCHES[name] += 1
        if back is not None:
            back.copy_(y)
    launch.tensors = keep
    return launch


def _checked_input(name, x):
    if x.dtype != torch.bfloat16 or x.dim() != 5:
        raise ValueError(f"{name}: needs a bf16 (N, X, Y, Z, C) tensor, got "
                         f"{x.dtype} {tuple(x.shape)}")


def _packed(name, x, w, b, w_packed, taps, pack):
    if w_packed is None:
        if w is None or tuple(w.shape[:4]) != (taps,) * 3 + (x.shape[-1],):
            raise ValueError(f"{name}: weight {None if w is None else tuple(w.shape)} "
                             f"does not fit input {tuple(x.shape)}")
        w_packed = pack(w.to(x.device), b)
    _kind(name, w_packed)
    if w_packed.cin != x.shape[-1]:
        raise ValueError(f"{name}: packed weights for cin {w_packed.cin}, "
                         f"input {tuple(x.shape)}")
    return w_packed


def _strided_input(x: torch.Tensor) -> tuple[torch.Tensor, int]:
    """(x, voxel stride) as the stride-2 kernel reads it: 16-byte aligned,
    channels and voxel stride multiples of 8. A channel slice of the concat
    qualifies as it is; anything else is copied (and zero-padded to 8
    channels) first."""
    ld = _voxel_stride(x)
    if ld is not None and x.shape[-1] % 8 == 0 and ld % 8 == 0 and x.data_ptr() % 16 == 0:
        return x, ld
    cin8 = _round_up(x.shape[-1], 8)
    return F.pad(x, (0, cin8 - x.shape[-1])).contiguous(), cin8


def _rows_call(x, norm, w, b, *, slope=1.0, out_dtype=torch.bfloat16,
               w_packed=None, out=None, split=None):
    """K1 on the wide-channel kernel: `pallas_conv._launch` with this call's
    batch and output voxel stride. `split` = (splits, taps) replaces the
    split plan, for tests; the wrapper never passes it."""
    name = "conv3d_rows"
    _checked_input(name, x)
    dev = x.device
    p = _packed(name, x, w, b, w_packed, 3, pack_rows)
    cout = p.cout
    n, X, Y, Z, cin = x.shape
    plan = ck, nch, _, cout_p = _rows_plan(cin, cout)
    rows = _norm_rows(norm, slope, n, cin, nch * ck, dev)
    xq = x.contiguous()
    if xq.data_ptr() % 16:
        xq = xq.clone()
    es = torch.finfo(out_dtype).bits // 8
    y, ldy, back = _out_buffer(out, (n, X, Y, Z), cout, cout_p, out_dtype, dev, 2 * es)
    sums = torch.empty((n, 2, cout_p), dtype=torch.float32, device=dev)
    if split is None:
        split = (1, 1) if ck == 1 else pc._split_plan(X, Y, Z, cin, cout, pc._sms(dev), n)
    kernel = pc._launch(name, LAUNCHES, xq, rows, p.w, p.bias, plan, y, ldy, sums, split,
                        out_dtype)
    launch = kernel
    if back is not None:
        def launch() -> None:
            kernel()
            back.copy_(y[..., :cout])
        launch.tensors, launch.split = kernel.tensors, kernel.split
    return launch, (y[..., :cout] if back is None else back, sums[..., :cout])


def _stride2_call(x, norm, w, b, *, slope=1.0, out_dtype=torch.bfloat16,
                  w_packed=None):
    from boa_tpu_torch import _build

    name = "conv3d_rows_stride2"
    _checked_input(name, x)
    dev = x.device
    p = _packed(name, x, w, b, w_packed, 3, pack_conv)
    cout, cout_p = p.cout, p.bias.numel()
    n, X, Y, Z, cin = x.shape
    cin_k = _round_up(cin, 16)   # channels past cin have scale 0: act 0
    if cin_k > 64:
        raise ValueError(f"{name}: cin {cin} > 64")
    rows = _norm_rows(norm, slope, n, cin, cin_k, dev)
    sums = torch.zeros((n, 2, cout_p), dtype=torch.float32, device=dev)
    x, ldx = _strided_input(x)
    Xo, Yo, Zo = ((v + 1) // 2 for v in (X, Y, Z))
    y = torch.empty((n, Xo, Yo, Zo, cout_p), dtype=out_dtype, device=dev)
    args = (x.data_ptr(), rows.data_ptr(), p.w.data_ptr(), p.bias.data_ptr(),
            y.data_ptr(), sums.data_ptr(), n, X, Y, Z, x.shape[-1], cin_k,
            ldx, cout_p, _out_f32(out_dtype), _stream())
    fn = _build.lib("stride2conv").boa_stride2conv_fwd
    launch = _launcher(name, fn, args, (x, rows, p, y, sums))
    return launch, (y[..., :cout], sums[..., :cout])


def _transp_call(x, w, b=None, *, out_dtype=torch.bfloat16, w_packed=None,
                 out=None):
    from boa_tpu_torch import _build

    name = "transpconv2_rows"
    _checked_input(name, x)
    dev = x.device
    p = _packed(name, x, w, b, w_packed, 2, pack_transp)
    cout, cout_p = p.cout, p.bias.numel()
    n, X, Y, Z, cin = x.shape
    cin_p = _round_up(cin, 16)
    if cin_p > 128:
        raise ValueError(f"{name}: cin {cin} > 128")
    x = F.pad(x, (0, cin_p - cin)) if cin_p != cin else x.contiguous()
    y, ldy, back = _out_buffer(out, (n, 2 * X, 2 * Y, 2 * Z), cout, cout_p,
                               out_dtype, dev, 16)
    args = (x.data_ptr(), p.w.data_ptr(), p.bias.data_ptr(), y.data_ptr(), n, X,
            Y, Z, cin_p, cout_p, ldy, _out_f32(out_dtype), _stream())
    launch = _launcher(name, _build.lib("transpconv").boa_transpconv2_fwd, args,
                       (x, p, y), back, y[..., :cout])
    return launch, (y[..., :cout] if back is None else back)


def _run(call):
    launch, res = call
    launch()
    return res


def prepare_launch(name: str, *args, **kw) -> tuple[Callable[[], None], object]:
    """(launch, result) of the wrapper `name` on CUDA tensors, with the same
    arguments: everything the wrapper does before its launch (packing unless
    `w_packed` is given, norm rows, output buffers) is done here, once;
    `launch()` runs the kernel alone (and counts it) and fills `result`,
    which the wrapper would return. `conv3d_rows` also takes `split` =
    (splits, taps) in place of its split plan, and its launch zeroes the
    sums and, when split, runs the finishing pass."""
    if name == "conv3d_rows":
        return _rows_call(*args, **kw)
    if name == "conv3d_rows_stride2":
        return _stride2_call(*args, **kw)
    if name == "transpconv2_rows":
        return _transp_call(*args, **kw)
    raise ValueError(f"unknown kernel {name}")


# ---------------------------------------------------------------------------
# public wrappers
# ---------------------------------------------------------------------------


def conv3d_rows(x: torch.Tensor, norm: NormAct, w: torch.Tensor | None,
                b: torch.Tensor | None, *, slope=1.0,
                out_dtype=torch.bfloat16, w_packed: Packed | None = None,
                out: torch.Tensor | None = None):
    """y = conv3d(act(x), w, stride 1, 'same') + b, plus per-sample sums.

    x: (N, X, Y, Z, cin) raw activations (`norm` carries x's own IN tail,
    identity for the network input); w: (3, 3, 3, cin, cout), or None with
    `w_packed` from `pack_rows`; slope: scalar or (cin,) LeakyReLU slope of
    act; out: optional (N, X, Y, Z, cout) view to write y into. Returns
    (y (N, X, Y, Z, cout), sums (N, 2, cout) float32 = [sum y, sum y^2] from
    the fp32 values)."""
    if _route(x):
        return _run(_rows_call(x, norm, w, b, slope=slope, out_dtype=out_dtype,
                               w_packed=w_packed, out=out))
    return conv3d_rows_plain(x, norm, w, b, slope=slope, out_dtype=out_dtype,
                             w_packed=w_packed, out=out)


def conv3d_rows_stride2(x: torch.Tensor, norm: NormAct, w: torch.Tensor | None,
                        b: torch.Tensor | None, *, slope=1.0,
                        out_dtype=torch.bfloat16,
                        w_packed: Packed | None = None):
    """`conv3d_rows` at stride 2, padding 1: out[o] = sum_d w[d] act(x)[2o+d-1]
    (torch Conv3d(stride=2, padding=1)); output extents ceil(n/2). x may be
    a channel slice of a wider buffer; `w_packed` comes from `pack_conv`."""
    if _route(x):
        return _run(_stride2_call(x, norm, w, b, slope=slope, out_dtype=out_dtype,
                                  w_packed=w_packed))
    return conv3d_rows_stride2_plain(x, norm, w, b, slope=slope,
                                     out_dtype=out_dtype, w_packed=w_packed)


def transpconv2_rows(x: torch.Tensor, w: torch.Tensor | None,
                     b: torch.Tensor | None = None, *,
                     out_dtype=torch.bfloat16, w_packed: Packed | None = None,
                     out: torch.Tensor | None = None) -> torch.Tensor:
    """2x2x2 stride-2 transposed conv with its bias:
    out[n, 2x+a, 2y+b, 2z+c, co] = sum_ci x[n, x, y, z, ci] w[a, b, c, ci, co]
    + b[co], summed in fp32 and rounded once. `out`: optional
    (N, 2X, 2Y, 2Z, cout) view (e.g. the first channels of the decoder
    concat) to write into."""
    if _route(x):
        return _run(_transp_call(x, w, b, out_dtype=out_dtype,
                                 w_packed=w_packed, out=out))
    return transpconv2_rows_plain(x, w, b, out_dtype=out_dtype,
                                  w_packed=w_packed, out=out)


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
