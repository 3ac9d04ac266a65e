"""Fused conv + input-side instance norm + LeakyReLU, wide channels (K5),
and the helpers the conv kernel wrappers share.

Counterpart of `boa_tpu/ops/pallas_conv.py` (`NormAct`, `identity_normact`,
`conv3d_in_act`, `stats_from_sums`). `conv3d_in_act` is a kernel wrapper:
a CPU tensor takes the plain PyTorch version `conv3d_in_act_plain` (same
contract, same bf16 rounding points); a CUDA tensor launches
`csrc/conv_in_act.cu` or raises. Each call adds one to
`LAUNCHES["conv3d_in_act"]`; a call that `_split_plan` splits over K also
launches the kernel's finishing pass, counted in
`LAUNCHES["conv3d_in_act_finish"]`. The same kernel serves the batched
stride-1 `ops/rowconv.py:conv3d_rows` (K1) through `_launch`.

The reference's `plan_packing` and `pack_weights` build the TPU's z-packed
lane layout (p z-slices share the 128 lanes) with group-shift weight
matrices. That layout has no counterpart here: the kernel reads plain
channels-last activations, and `pack_in_act_weights` packs the weights in
the kernel's own fragment order.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F

#: kernel launches since the last `reset_launches()`
LAUNCHES: dict[str, int] = {"conv3d_in_act": 0, "conv3d_in_act_finish": 0}

#: the most bytes the fp32 workspace of a split call may take
SPLIT_WORKSPACE_BYTES = 32 << 20


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


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# helpers shared with ops/rowconv.py
# ---------------------------------------------------------------------------


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


def _conv_plain(x, norm, w, b, slope, stride, out_dtype):
    """The fused conv on (N, X, Y, Z, cin) in plain PyTorch: x rounded to
    bf16, norm + act in fp32, act and w rounded to bf16, fp32 products and
    sums."""
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


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _out_f32(out_dtype) -> int:
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"out_dtype {out_dtype} not supported by the kernel")
    return int(out_dtype == torch.float32)


def _route(x: torch.Tensor) -> bool:
    """True: launch the kernel (CUDA tensor); False: plain version (CPU)."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {x.device}")


# ---------------------------------------------------------------------------
# K5: conv3d_in_act
# ---------------------------------------------------------------------------


def _plan(cin: int, cout: int, fold: bool = False) -> tuple[int, int, int, int]:
    """(ck, nchunks, bn, cout_p): input channels per chunk, chunks, output
    channels per N tile and cout padded to whole tiles. `fold` (cin = 1):
    the kernel's tap-folded input conv, ck = 1 and 32-wide N tiles."""
    if fold:
        if cin != 1:
            raise ValueError(f"the tap-folded conv takes cin 1, not {cin}")
        return 1, 1, 32, _round_up(cout, 32)
    ck = 16 if cin <= 16 else 32
    bn = 32 if cout <= 32 else 64
    return ck, -(-cin // ck), bn, _round_up(cout, bn)


def _blocks(X: int, Y: int, Z: int, bn: int, cout_p: int) -> int:
    """Blocks of one K split: the kernel's 4 x TY x 16 output bricks (TY = 4
    at bn 64, 8 at bn 32) times its N tiles."""
    ty = 4 if bn == 64 else 8
    return -(-X // 4) * -(-Y // ty) * -(-Z // 16) * (cout_p // bn)


def _sms(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _split_plan(X: int, Y: int, Z: int, cin: int, cout: int, sms: int,
                n: int = 1) -> tuple[int, int]:
    """(splits, taps) of a call on `n` samples on a card with `sms` SMs. K is nchunks *
    taps units (taps 1: whole chunks; taps 3: a chunk's dx tap planes), cut
    into `splits` contiguous ranges of at most `per` units each. The aim is
    about two blocks per SM, as many as the kernel keeps resident; of the
    two unit sizes the one that leaves less work per split wins, whole
    chunks on a tie (a tap plane stages 4 of the window's 6 planes for a
    third of the products). The fp32 workspace stays within
    SPLIT_WORKSPACE_BYTES."""
    _, nch, bn, cout_p = _plan(cin, cout)
    want = max(1, 2 * sms // (n * _blocks(X, Y, Z, bn, cout_p)))
    per1, per3 = -(-nch // want), -(-3 * nch // want)
    taps, per = (3, per3) if per3 < 3 * per1 else (1, per1)
    splits = -(-nch * taps // per)
    while splits > 1 and n * splits * X * Y * Z * cout_p * 4 > SPLIT_WORKSPACE_BYTES:
        per += 1
        splits = -(-nch * taps // per)
    return splits, (taps if splits > 1 else 1)


def _split_units(k: int, splits: int, units: int) -> range:
    """The K units of split k, as the kernel cuts them."""
    return range(k * units // splits, (k + 1) * units // splits)


def pack_in_act_weights(w: torch.Tensor, fold: bool = False) -> torch.Tensor:
    """(3, 3, 3, cin, cout) -> the K5 kernel's B fragments, bf16, zero padded
    to whole chunks and N tiles: for N tile nb, chunk c, tap
    (dx*3 + dy)*3 + dz, k step s, column pair p and lane 4g + t, the eight
    values w[tap, c*ck + s*16 + 8h + 2t + e, nb*bn + p*16 + 8q + g] in
    (q, h, e) order, i.e. the two m16n8k16 B registers of two n8 tiles, in
    the order the lane holds them. `fold` (cin = 1): K is the 27 taps padded
    to 32, and for k step s < 2, column pair p of the whole cout and lane
    4g + t the eight values w[k = s*16 + 8h + 2t + e, p*16 + 8q + g]."""
    cin, cout = w.shape[3], w.shape[4]
    ck, nch, bn, cout_p = _plan(cin, cout, fold)
    if fold:
        wq = F.pad(w.to(torch.bfloat16).reshape(27, cout), (0, cout_p - cout, 0, 5))
        #                 s  h  t  e  p             q  g
        wq = wq.reshape(2, 2, 4, 2, cout_p // 16, 2, 8)
        return wq.permute(0, 4, 6, 2, 5, 1, 3).contiguous()
    wq = F.pad(w.to(torch.bfloat16), (0, cout_p - cout, 0, nch * ck - cin))
    #                  tap  c    s        h  t  e  nb            p        q  g
    wq = wq.reshape(27, nch, ck // 16, 2, 4, 2, cout_p // bn, bn // 16, 2, 8)
    return wq.permute(6, 1, 0, 2, 7, 9, 4, 8, 3, 5).contiguous()


def unpack_in_act_weights(wp: torch.Tensor, cin: int, cout: int,
                          fold: bool = False) -> torch.Tensor:
    """Inverse of `pack_in_act_weights`: (3, 3, 3, cin, cout) bf16."""
    ck, nch, bn, cout_p = _plan(cin, cout, fold)
    if fold:
        w = wp.reshape(2, cout_p // 16, 8, 4, 2, 2, 2).permute(0, 5, 3, 6, 1, 4, 2)
        return w.reshape(32, cout_p)[:27, :cout].reshape(3, 3, 3, 1, cout)
    w = wp.reshape(cout_p // bn, nch, 27, ck // 16, bn // 16, 8, 4, 2, 2, 2)
    w = w.permute(2, 1, 3, 8, 6, 9, 0, 4, 7, 5).reshape(27, nch * ck, cout_p)
    return w[:, :cin, :cout].reshape(3, 3, 3, cin, cout)


def _shapes(x, w, w_packed, cin, cout) -> tuple[int, int]:
    """(cin, cout) of a call; raises on what does not fit."""
    cin_x = x.shape[-1]
    cout = cout if cout is not None else (w.shape[-1] if w is not None else None)
    if x.dim() != 4 or (cin is not None and cin != cin_x) or cout is None:
        raise ValueError(f"conv3d_in_act: input {tuple(x.shape)}, cin {cin}, "
                         f"cout {cout}: needs (X, Y, Z, cin) and w or cout")
    if w_packed is None and (w is None or tuple(w.shape) != (3, 3, 3, cin_x, cout)):
        raise ValueError(f"conv3d_in_act: weight {None if w is None else tuple(w.shape)} "
                         f"does not fit input {tuple(x.shape)}")
    return int(cin_x), int(cout)


def conv3d_in_act_plain(x: torch.Tensor, norm: NormAct, w: torch.Tensor | None,
                        b: torch.Tensor | None, *, slope: float = 1.0,
                        out_dtype=torch.bfloat16,
                        w_packed: torch.Tensor | None = None,
                        cin: int | None = None, cout: int | None = None):
    """`conv3d_in_act` in plain PyTorch, on any device."""
    cin, cout = _shapes(x, w, w_packed, cin, cout)
    if w_packed is not None:
        w = unpack_in_act_weights(w_packed, cin, cout)
    y, sums = _conv_plain(x[None], norm, w, b, slope, 1, out_dtype)
    return y[0], sums[0]


def split_partials_plain(x: torch.Tensor, norm: NormAct, w: torch.Tensor, *,
                         slope=1.0, splits: int, taps: int) -> torch.Tensor:
    """What the K splits of a split call store in the workspace, in plain
    PyTorch: (splits, X, Y, Z, cout) float32 partial sums without bias for
    x (X, Y, Z, cin), (N, splits, X, Y, Z, cout) for a batch x (N, X, Y, Z,
    cin). Split k's conv keeps only the weights of its units' input channels
    and dx tap planes; the rounding points are `conv3d_in_act_plain`'s."""
    batched = x.dim() == 5
    xb = x if batched else x[None]
    cin, cout = w.shape[3], w.shape[4]
    ck, nch, _, _ = _plan(cin, cout)
    parts = []
    for k in range(splits):
        keep = torch.zeros(3, nch * ck, dtype=w.dtype, device=w.device)  # (dx, ci)
        for u in _split_units(k, splits, nch * taps):
            c = u // taps
            keep[slice(None) if taps == 1 else u % 3, c * ck:(c + 1) * ck] = 1
        wk = w * keep[:, None, None, :cin, None]
        parts.append(_conv_plain(xb, norm, wk, None, slope, 1, torch.float32)[0])
    parts = torch.stack(parts, dim=1)
    return parts if batched else parts[0]


def finish_plain(partials: torch.Tensor, b: torch.Tensor | None,
                 out_dtype=torch.bfloat16):
    """The kernel's finishing pass in plain PyTorch: the (splits, X, Y, Z,
    cout) partial sums added in split order, plus the fp32 bias, rounded
    once to out_dtype; the sums from the fp32 values. Returns (y, sums
    (2, cout)), or per sample (y (N, X, Y, Z, cout), sums (N, 2, cout)) for
    (N, splits, X, Y, Z, cout) partials."""
    batched = partials.dim() == 6
    parts = partials if batched else partials[None]
    y = parts[:, 0]
    for k in range(1, parts.shape[1]):
        y = y + parts[:, k]
    y = y + _bias(b, y.shape[-1], y.device)
    sums = torch.stack([y.sum((1, 2, 3)), (y * y).sum((1, 2, 3))], dim=1)
    y = y.to(out_dtype)
    return (y, sums) if batched else (y[0], sums[0])


def _launch(name: str, counts: dict[str, int], x: torch.Tensor, rows: torch.Tensor,
            wp: torch.Tensor, bias: torch.Tensor, plan: tuple[int, int, int, int],
            y: torch.Tensor, ldy: int, sums: torch.Tensor, split: tuple[int, int],
            out_dtype) -> Callable[[], None]:
    """The launch of one prepared call of csrc/conv_in_act.cu. x (N, X, Y, Z,
    cin) bf16, contiguous and 16-byte aligned; rows (N, 4, nchunks * ck);
    wp and bias (cout_p,) packed for `plan` = (ck, nchunks, bn, cout_p); y
    the buffer the kernel writes, its voxels ldy elements apart; sums (N, 2,
    cout_p). `launch()` zeroes sums, runs the kernel and, for splits > 1, its
    finishing pass, and counts them in counts[name] and
    counts[name + "_finish"]."""
    from boa_tpu_torch import _build

    n, X, Y, Z, cin = x.shape
    ck, nch, bn, cout_p = plan
    splits, taps = split
    ws = (torch.empty((n, splits, X * Y * Z, cout_p), dtype=torch.float32, device=x.device)
          if splits > 1 else None)
    lib = _build.lib("conv_in_act")
    out_f32, stream = _out_f32(out_dtype), _stream()
    args = (x.data_ptr(), rows.data_ptr(), wp.data_ptr(), bias.data_ptr(),
            y.data_ptr(), sums.data_ptr(), None if ws is None else ws.data_ptr(),
            n, X, Y, Z, cin, ck, nch, cout_p, bn, ldy, splits, taps, out_f32, stream)
    fin_args = (None if ws is None else ws.data_ptr(), bias.data_ptr(), y.data_ptr(),
                sums.data_ptr(), n, X * Y * Z, cout_p, ldy, splits, out_f32, stream)

    def launch() -> None:
        sums.zero_()
        _build.check(lib.boa_conv_in_act_fwd(*args), name)
        if splits > 1:
            _build.check(lib.boa_conv_in_act_finish(*fin_args), name + " finish")
            counts[name + "_finish"] += 1
        counts[name] += 1
    launch.tensors = (x, rows, wp, bias, y, sums, ws)
    launch.split = split
    return launch


def prepare_launch(x: torch.Tensor, norm: NormAct, w: torch.Tensor | None,
                   b: torch.Tensor | None, *, slope: float = 1.0,
                   out_dtype=torch.bfloat16,
                   w_packed: torch.Tensor | None = None,
                   cin: int | None = None, cout: int | None = None,
                   split: tuple[int, int] | None = None):
    """(launch, (y, sums)) of `conv3d_in_act` on CUDA tensors, with the same
    arguments: the weight packing (unless `w_packed` is given), the padded
    bias, the norm rows, the output buffers and the split workspace are
    made here, once; `launch()` zeroes `sums`, runs the kernel alone (and,
    when split, its finishing pass), counts it and fills `(y, sums)`, which
    the wrapper would return. `split` = (splits, taps) replaces
    `_split_plan`'s choice, for tests; the wrapper never passes it."""
    cin, cout = _shapes(x, w, w_packed, cin, cout)
    if w_packed is None:
        w_packed = pack_in_act_weights(w.to(x.device))
    plan = ck, nch, bn, cout_p = _plan(cin, cout)
    if w_packed.dtype != torch.bfloat16 or w_packed.numel() != 27 * nch * ck * cout_p:
        raise ValueError("conv3d_in_act: w_packed does not fit cin/cout")
    dev = x.device
    X, Y, Z, _ = x.shape
    xq = x.to(torch.bfloat16).contiguous()  # the reference casts x before the norm
    if xq.data_ptr() % 16:
        xq = xq.clone()
    wp = w_packed.to(dev).contiguous()
    bias = torch.zeros(cout_p, dtype=torch.float32, device=dev)
    bias[:cout] = _bias(b, cout, dev)
    rows = _norm_rows(norm, slope, 1, cin, nch * ck, dev)
    y = torch.empty((1, X, Y, Z, cout_p), dtype=out_dtype, device=dev)
    sums = torch.empty((1, 2, cout_p), dtype=torch.float32, device=dev)
    if split is None:
        split = _split_plan(X, Y, Z, cin, cout, _sms(dev))
    launch = _launch("conv3d_in_act", LAUNCHES, xq[None], rows, wp, bias, plan, y, cout_p,
                     sums, split, out_dtype)
    return launch, (y[0, ..., :cout], sums[0, :, :cout])


def conv3d_in_act(x: torch.Tensor, norm: NormAct, w: torch.Tensor | None,
                  b: torch.Tensor | None, *, slope: float = 1.0,
                  out_dtype=torch.bfloat16,
                  w_packed: torch.Tensor | None = None,
                  cin: int | None = None, cout: int | None = None):
    """y_raw = conv3d(act(IN(x_raw)), w, stride 1, 'same') + b, plus
    per-channel (sum y, sum y^2).

    x: (X, Y, Z, Cin) raw (un-normalized) activations, one sample; `norm`
    carries the stats/affine of x's own instance norm (identity for the
    network input). w: (3, 3, 3, Cin, Cout); b: (Cout,) or None. Returns
    (y (X, Y, Z, Cout) out_dtype, sums (2, Cout) float32 = [sum y, sum y^2]).
    Pass `w_packed` (from `pack_in_act_weights`) plus cin/cout to skip the
    per-call packing. Weights are rounded to bf16 either way."""
    if _route(x):
        launch, res = prepare_launch(x, norm, w, b, slope=slope, out_dtype=out_dtype,
                                     w_packed=w_packed, cin=cin, cout=cout)
        launch()
        return res
    return conv3d_in_act_plain(x, norm, w, b, slope=slope, out_dtype=out_dtype,
                               w_packed=w_packed, cin=cin, cout=cout)
