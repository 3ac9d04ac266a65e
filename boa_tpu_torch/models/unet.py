"""nnU-Net U-Net inference in PyTorch, with the row-conv composite forward.

Counterpart of `boa_tpu/models/unet.py` (`ArchConfig`,
`arch_config_from_plans`, `unet_forward`, `_rowconv_forward`,
`unet_infer`). Public layout as in the reference: the network takes
(N, X, Y, Z, C) and returns (N, X, Y, Z, num_classes); the eager layers run
on torch's (N, C, X, Y, Z) with (X, Y, Z) as (D, H, W).

Both of nnU-Net's encoder families: `PlainConvUNet` (conv blocks) and
`ResidualEncoderUNet` (a stem conv block, then BasicBlockD residual blocks:
conv1 -> conv2 without its nonlinearity, plus the skip, a strided 1x1x1
conv + instance norm where the stride or the width changes; `make_unet`
picks the class). A 2d configuration runs as a 3d net with (k, k, 1)
kernels and strides and per-slice instance-norm statistics (InstanceNorm2d).
With `cfg.deep_supervision`, `forward(x, all_heads=True)` returns one head
per decoder stage, highest resolution first.

Two forwards:

* eager: Conv3d -> instance norm (statistics in fp32 whatever the compute
  dtype, like the reference) -> LeakyReLU per block, ConvTranspose3d
  upsampling, 1x1x1 head. The fp32 path is held to the reference at 1e-4.
* composite (`_rowconv_forward`): taken whenever the compute dtype is bf16
  and the geometry qualifies (`_rowconv_eligible`). Stage 0, the stride-2
  boundary, the last upsample and the last decoder stage run on the
  row-conv kernels of `ops/rowconv.py`, whose fused sums give the instance
  norm statistics, so the normalized 128^3 activations never reach device
  memory; the interior stages (64^3 and below) stay eager. Residual and
  2d configurations never take it (the reference's rule), and neither do
  the deep-supervision heads.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import NamedTuple

import torch
import torch.nn as nn

from boa_tpu_torch.device import resolve_device
from boa_tpu_torch.ops import rowconv as rc


@dataclass(frozen=True)
class ArchConfig:
    """Static architecture hyperparameters."""

    n_stages: int
    features_per_stage: tuple[int, ...]
    kernel_sizes: tuple[tuple[int, int, int], ...]
    strides: tuple[tuple[int, int, int], ...]
    n_conv_per_stage: tuple[int, ...]
    n_conv_per_stage_decoder: tuple[int, ...]
    num_classes: int
    input_channels: int = 1
    conv_bias: bool = True
    norm_eps: float = 1e-5
    norm_affine: bool = True
    nonlin_slope: float = 0.01  # torch.nn.LeakyReLU default negative_slope
    deep_supervision: bool = False
    residual_encoder: bool = False
    n_blocks_per_stage: tuple[int, ...] | None = None
    two_d: bool = False


def arch_config_from_plans(arch: dict, num_classes: int, input_channels: int = 1,
                           deep_supervision: bool = False) -> ArchConfig:
    """ArchConfig from a plans.json ``architecture`` dict."""
    kw = arch["arch_kwargs"]
    class_name = arch["network_class_name"].rsplit(".", 1)[-1]
    residual = class_name == "ResidualEncoderUNet"
    first = kw["kernel_sizes"][0]
    two_d = isinstance(first, (list, tuple)) and len(first) == 2

    def _tup3(v):
        out = []
        for k in v:
            if not isinstance(k, (list, tuple)):
                k = (k, k) if two_d else (k, k, k)
            k = tuple(int(x) for x in k)
            out.append(k + (1,) if two_d else k)
        return tuple(out)

    n_stages = int(kw["n_stages"])
    fps = kw["features_per_stage"]
    fps = tuple(int(f) for f in (fps if isinstance(fps, (list, tuple))
                                 else [fps] * n_stages))
    n_conv = kw.get("n_conv_per_stage", kw.get("n_blocks_per_stage", 2))
    n_conv = tuple(int(c) for c in (n_conv if isinstance(n_conv, (list, tuple))
                                    else [n_conv] * n_stages))
    n_dec = kw.get("n_conv_per_stage_decoder", 2)
    n_dec = tuple(int(c) for c in (n_dec if isinstance(n_dec, (list, tuple))
                                   else [n_dec] * (n_stages - 1)))
    norm_kw = kw.get("norm_op_kwargs") or {}
    return ArchConfig(
        n_stages=n_stages,
        features_per_stage=fps,
        kernel_sizes=_tup3(kw["kernel_sizes"]),
        strides=_tup3(kw["strides"]),
        n_conv_per_stage=n_conv if not residual else tuple([2] * n_stages),
        n_conv_per_stage_decoder=n_dec,
        num_classes=num_classes,
        input_channels=input_channels,
        conv_bias=bool(kw.get("conv_bias", True)),
        norm_eps=float(norm_kw.get("eps", 1e-5)),
        norm_affine=bool(norm_kw.get("affine", True)),
        deep_supervision=deep_supervision,
        residual_encoder=residual,
        n_blocks_per_stage=n_conv if residual else None,
        two_d=two_d,
    )


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def _lrelu(x: torch.Tensor, slope: float) -> torch.Tensor:
    # the slope is rounded to the compute dtype first, as in the reference
    return torch.where(x >= 0, x, x * torch.tensor(slope, dtype=x.dtype,
                                                   device=x.device))


def instance_norm(x: torch.Tensor, scale, bias, eps: float,
                  dims: tuple[int, ...] = (2, 3, 4)) -> torch.Tensor:
    """InstanceNorm3d on (N, C, X, Y, Z): fp32 statistics, biased variance,
    reduced over `dims` (the in-plane (2, 3) alone for a 2d configuration)."""
    xf = x.float()
    mean = xf.mean(dim=dims, keepdim=True)
    var = (xf - mean).square().mean(dim=dims, keepdim=True)
    out = (xf - mean) * torch.rsqrt(var + eps)
    if scale is not None:
        out = out * scale.float()[None, :, None, None, None]
    if bias is not None:
        out = out + bias.float()[None, :, None, None, None]
    return out.to(x.dtype)


def _in_dims(cfg: ArchConfig) -> tuple[int, ...]:
    """Instance-norm reduction dims of (N, C, X, Y, Z): the volume, or the
    slice for a 2d configuration (the reference's `_in_axes`)."""
    return (2, 3) if cfg.two_d else (2, 3, 4)


class ConvBlock(nn.Module):
    """Conv3d -> InstanceNorm3d(affine) -> LeakyReLU (no LeakyReLU with
    `nonlin=False`: BasicBlockD's conv2 and skip)."""

    def __init__(self, cin: int, cout: int, kernel, stride, cfg: ArchConfig,
                 device=None, nonlin: bool = True):
        super().__init__()
        self.conv = nn.Conv3d(cin, cout, tuple(kernel), tuple(stride),
                              padding=tuple((k - 1) // 2 for k in kernel),
                              bias=cfg.conv_bias, device=device)
        self.norm = nn.InstanceNorm3d(cout, eps=cfg.norm_eps,
                                      affine=cfg.norm_affine, device=device)
        self.slope = cfg.nonlin_slope if nonlin else None
        self.dims = _in_dims(cfg)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        x = instance_norm(x, self.norm.weight, self.norm.bias, self.norm.eps,
                          self.dims)
        return x if self.slope is None else _lrelu(x, self.slope)


class BasicBlockD(nn.Module):
    """The residual encoder's block: LeakyReLU(conv2(conv1(x)) + skip(x)),
    skip a strided 1x1x1 conv + instance norm where the stride or the width
    changes, else the identity (reference `unet.py:_encoder_forward`)."""

    def __init__(self, cin: int, cout: int, kernel, stride, cfg: ArchConfig,
                 device=None):
        super().__init__()
        self.conv1 = ConvBlock(cin, cout, kernel, stride, cfg, device)
        self.conv2 = ConvBlock(cout, cout, kernel, (1, 1, 1), cfg, device,
                               nonlin=False)
        self.skip = (ConvBlock(cin, cout, (1, 1, 1), stride, cfg, device,
                               nonlin=False)
                     if any(s != 1 for s in stride) or cin != cout else None)
        self.slope = cfg.nonlin_slope

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv2(self.conv1(x))
        return _lrelu(y + (x if self.skip is None else self.skip(x)), self.slope)


class DecoderStage(nn.Module):
    def __init__(self, c_below: int, c_skip: int, stride, kernel, n_conv: int,
                 cfg: ArchConfig, device=None):
        super().__init__()
        self.transp = nn.ConvTranspose3d(c_below, c_skip, tuple(stride),
                                         tuple(stride), bias=True,
                                         device=device)
        c = 2 * c_skip
        convs = []
        for _ in range(n_conv):
            convs.append(ConvBlock(c, c_skip, kernel, (1, 1, 1), cfg, device))
            c = c_skip
        self.convs = nn.ModuleList(convs)


class PlainConvUNet(nn.Module):
    """nnU-Net PlainConvUNet, inference heads only; built on `device`
    (default the card)."""

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        if cfg.residual_encoder != isinstance(self, ResidualEncoderUNet):
            raise ValueError(f"{type(self).__name__} does not build "
                             f"residual_encoder={cfg.residual_encoder}: use "
                             f"make_unet")
        device = resolve_device(device)
        self.cfg = cfg
        self.encoder = self._build_encoder(cfg, device)
        dec, heads = [], []
        for s in range(cfg.n_stages - 1, 0, -1):
            c_skip = cfg.features_per_stage[s - 1]
            dec.append(DecoderStage(
                cfg.features_per_stage[s], c_skip, cfg.strides[s],
                cfg.kernel_sizes[s - 1],
                cfg.n_conv_per_stage_decoder[cfg.n_stages - 1 - s], cfg,
                device))
            heads.append(nn.Conv3d(c_skip, cfg.num_classes, 1, bias=True,
                                   device=device))
        self.decoder = nn.ModuleList(dec)
        self.seg_heads = nn.ModuleList(heads)

    @staticmethod
    def _build_encoder(cfg: ArchConfig, device) -> nn.ModuleList:
        enc = []
        c_in = cfg.input_channels
        for s in range(cfg.n_stages):
            c_out = cfg.features_per_stage[s]
            stage = []
            for b in range(cfg.n_conv_per_stage[s]):
                stride = cfg.strides[s] if b == 0 else (1, 1, 1)
                stage.append(ConvBlock(c_in, c_out, cfg.kernel_sizes[s],
                                       stride, cfg, device))
                c_in = c_out
            enc.append(nn.ModuleList(stage))
        return nn.ModuleList(enc)

    def forward(self, x: torch.Tensor, ops: rc.RowOps = rc.KERNELS,
                all_heads: bool = False):
        """(N, X, Y, Z, C) -> logits (N, X, Y, Z, num_classes), or with
        `all_heads` on a deep-supervision config the list of every decoder
        stage's logits, highest resolution first.

        bf16 input on a qualifying geometry takes the row-conv composite
        (`ops` selects its three functions: the kernel wrappers, or the plain
        versions as a yardstick); everything else runs eager."""
        if (not all_heads and x.dtype == torch.bfloat16
                and _rowconv_eligible(self.cfg, x.shape)):
            return _rowconv_forward(self, x, ops)
        return self.forward_eager(x, all_heads)

    def _encode(self, h: torch.Tensor) -> list[torch.Tensor]:
        skips = []
        for stage in self.encoder:
            for blk in stage:
                h = blk(h)
            skips.append(h)
        return skips

    def forward_eager(self, x: torch.Tensor, all_heads: bool = False):
        skips = self._encode(x.permute(0, 4, 1, 2, 3))
        y = skips[-1]
        n = self.cfg.n_stages
        every = self.cfg.deep_supervision and all_heads
        outs = []
        for i, st in enumerate(self.decoder):
            y = torch.cat([st.transp(y), skips[n - 2 - i]], dim=1)
            for blk in st.convs:
                y = blk(y)
            if every or i == len(self.decoder) - 1:
                outs.append(self.seg_heads[i](y).permute(0, 2, 3, 4, 1))
        return outs[::-1] if every else outs[-1]


class ResidualEncoderUNet(PlainConvUNet):
    """nnU-Net ResidualEncoderUNet: a stem conv block, then
    `n_blocks_per_stage` BasicBlockD per stage (the first at the stage's
    stride); the decoder is PlainConvUNet's."""

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__(cfg, device)
        self.stem = ConvBlock(cfg.input_channels, cfg.features_per_stage[0],
                              cfg.kernel_sizes[0], (1, 1, 1), cfg,
                              self.seg_heads[0].weight.device)

    @staticmethod
    def _build_encoder(cfg: ArchConfig, device) -> nn.ModuleList:
        enc = []
        c_in = cfg.features_per_stage[0]
        for s in range(cfg.n_stages):
            c_out = cfg.features_per_stage[s]
            stage = []
            for b in range((cfg.n_blocks_per_stage or cfg.n_conv_per_stage)[s]):
                stride = cfg.strides[s] if b == 0 else (1, 1, 1)
                stage.append(BasicBlockD(c_in, c_out, cfg.kernel_sizes[s],
                                         stride, cfg, device))
                c_in = c_out
            enc.append(nn.ModuleList(stage))
        return nn.ModuleList(enc)

    def _encode(self, h: torch.Tensor) -> list[torch.Tensor]:
        return super()._encode(self.stem(h))


def make_unet(cfg: ArchConfig, device=None) -> PlainConvUNet:
    """The network class of `cfg`'s encoder family, on `device`."""
    cls = ResidualEncoderUNet if cfg.residual_encoder else PlainConvUNet
    return cls(cfg, device)


# ---------------------------------------------------------------------------
# row-conv composite
# ---------------------------------------------------------------------------


def _rowconv_eligible(cfg: ArchConfig, shape) -> bool:
    """A plain 3d encoder (never residual or 2d, as the reference), stage 0
    and the last decoder stage two 3x3x3 convs each, the first boundary a
    3x3x3 stride-2 conv, the first two stages no wider than the stride-2
    kernel's cout, and even tile extents. (The reference also asks for
    Y == 128 lanes and a batch of one, which were TPU constraints.)"""
    _, X, Y, Z, _ = shape
    return (not cfg.residual_encoder and not cfg.two_d
            and cfg.n_stages >= 2
            and max(cfg.features_per_stage[:2]) <= rc.CONV_MAX_COUT
            and cfg.kernel_sizes[0] == (3, 3, 3)
            and cfg.kernel_sizes[1] == (3, 3, 3)
            and cfg.strides[0] == (1, 1, 1)
            and cfg.strides[1] == (2, 2, 2)
            and cfg.n_conv_per_stage[0] == 2
            and cfg.n_conv_per_stage_decoder[cfg.n_stages - 2] == 2
            and X % 2 == 0 and Y % 2 == 0 and Z % 2 == 0)


def _wcl(conv: nn.Module) -> torch.Tensor:
    """torch (co, ci, kx, ky, kz) -> the kernels' (kx, ky, kz, ci, co)."""
    return conv.weight.permute(2, 3, 4, 1, 0)


def _affine(blk: ConvBlock, c: int, device):
    g, b = blk.norm.weight, blk.norm.bias
    return (g.float() if g is not None else torch.ones(c, device=device),
            b.float() if b is not None else torch.zeros(c, device=device))


class _RowPacks(NamedTuple):
    """The composite's kernel weights, packed once per model."""

    enc0: tuple[rc.Packed, rc.Packed]
    down: rc.Packed
    up: rc.Packed
    dec: tuple[rc.Packed, rc.Packed]


def _row_packs(model: PlainConvUNet) -> _RowPacks:
    """The packed weights of the composite's six kernel layers, cached on the
    model and packed again when a parameter moves or changes in place (its
    `data_ptr` or `_version`)."""
    enc0, st = model.encoder[0], model.decoder[-1]
    convs = (enc0[0].conv, enc0[1].conv, model.encoder[1][0].conv,
             st.convs[0].conv, st.convs[1].conv)
    params = [p for m in convs + (st.transp,) for p in (m.weight, m.bias)
              if p is not None]
    key = tuple((p.data_ptr(), p._version) for p in params)
    cached = model.__dict__.get("_row_packs")
    if cached is not None and cached[0] == key:
        return cached[1]
    # stride 1 for conv3d_rows (K1), stride 2 for conv3d_rows_stride2 (K2)
    c = [(rc.pack_conv if i == 2 else rc.pack_rows)(_wcl(m), m.bias)
         for i, m in enumerate(convs)]
    # ConvTranspose3d weight (ci, co, kx, ky, kz) -> (kx, ky, kz, ci, co)
    up = rc.pack_transp(st.transp.weight.permute(2, 3, 4, 0, 1), st.transp.bias)
    packs = _RowPacks((c[0], c[1]), c[2], up, (c[3], c[4]))
    model.__dict__["_row_packs"] = (key, packs)
    return packs


def _rowconv_forward(model: PlainConvUNet, x: torch.Tensor,
                     ops: rc.RowOps) -> torch.Tensor:
    """Mirror of the reference `_rowconv_forward` on channels-last tensors.

    The last decoder stage's concat is built in place: stage 0's second conv
    writes its output into the concat's last c0 channels, the stride-2 conv
    reads it there, and the transposed conv writes `up + bias` into the
    first c0. The reference rounds `up` to bf16 before adding the bf16 bias;
    here the sum is rounded once."""
    cfg = model.cfg
    dt, dev = x.dtype, x.device
    n, X, Y, Z, C = x.shape
    eps, slope = cfg.norm_eps, cfg.nonlin_slope
    c0 = cfg.features_per_stage[0]
    packs = _row_packs(model)

    def normact(blk, sums, count, c):
        mean, inv_std = rc.stats_from_sums(sums, count, eps)
        gamma, beta = _affine(blk, c, dev)
        return rc.NormAct(mean, inv_std, gamma, beta, slope)

    def norm_lrelu(y, blk, sums, count, c):
        m, isd = rc.stats_from_sums(sums, count, eps)   # (N, C)
        gamma, beta = _affine(blk, c, dev)
        yf = (y.float() - m[:, None, None, None]) * isd[:, None, None, None]
        return _lrelu((yf * gamma + beta).to(dt), slope)

    # ---- stage 0 on the kernels; y2 lands in the decoder concat
    enc0 = model.encoder[0]
    cnt0 = X * Y * Z
    cat = torch.empty((n, X, Y, Z, 2 * c0), dtype=dt, device=dev)
    y1, s1 = ops.conv3d_rows(x, rc.identity_normact(C, dev), None, None,
                             slope=1.0, out_dtype=dt, w_packed=packs.enc0[0])
    na1 = normact(enc0[0], s1, cnt0, c0)
    y2, s2 = ops.conv3d_rows(y1, na1, None, None, slope=slope, out_dtype=dt,
                             w_packed=packs.enc0[1], out=cat[..., c0:])
    na2 = normact(enc0[1], s2, cnt0, c0)

    # ---- stride-2 boundary into the eager interior
    enc1 = model.encoder[1]
    c1 = cfg.features_per_stage[1]
    y3, s3 = ops.conv3d_rows_stride2(y2, na2, None, None, slope=slope,
                                     out_dtype=dt, w_packed=packs.down)
    cnt1 = y3.shape[1] * y3.shape[2] * y3.shape[3]
    h = norm_lrelu(y3, enc1[0], s3, cnt1, c1).permute(0, 4, 1, 2, 3)
    for blk in enc1[1:]:
        h = blk(h)
    skips = [None, h]
    for stage in model.encoder[2:]:
        for blk in stage:
            h = blk(h)
        skips.append(h)

    y = skips[-1]
    for i, st in enumerate(model.decoder[:-1]):
        y = torch.cat([st.transp(y), skips[cfg.n_stages - 2 - i]], dim=1)
        for blk in st.convs:
            y = blk(y)

    # ---- last decoder stage on the kernels
    st = model.decoder[-1]
    yt = y.permute(0, 2, 3, 4, 1).contiguous()            # (N, X/2, Y/2, Z/2, c1)
    ops.transpconv2_rows(yt, None, None, out_dtype=dt, w_packed=packs.up,
                         out=cat[..., :c0])
    zeros = torch.zeros((n, c0), dtype=torch.float32, device=dev)
    ones = torch.ones((n, c0), dtype=torch.float32, device=dev)
    na_cat = rc.NormAct(
        mean=torch.cat([zeros, torch.broadcast_to(na2.mean, (n, c0))], 1),
        inv_std=torch.cat([ones, torch.broadcast_to(na2.inv_std, (n, c0))], 1),
        gamma=torch.cat([ones, torch.broadcast_to(na2.gamma, (n, c0))], 1),
        beta=torch.cat([zeros, torch.broadcast_to(na2.beta, (n, c0))], 1),
        slope=1.0)
    slope_vec = torch.cat([torch.ones(c0, device=dev),
                           torch.full((c0,), slope, device=dev)])
    convs = st.convs
    y4, s4 = ops.conv3d_rows(cat, na_cat, None, None, slope=slope_vec,
                             out_dtype=dt, w_packed=packs.dec[0])
    na4 = normact(convs[0], s4, cnt0, c0)
    y5, s5 = ops.conv3d_rows(y4, na4, None, None, slope=slope, out_dtype=dt,
                             w_packed=packs.dec[1])

    # ---- 1x1x1 head on the channels-last tensor
    xn5 = norm_lrelu(y5, convs[1], s5, cnt0, c0)
    head = model.seg_heads[-1]
    out = xn5 @ head.weight[:, :, 0, 0, 0].t().to(dt)
    if head.bias is not None:
        out = out + head.bias.to(dt)
    return out


def cast_model(model: PlainConvUNet, dtype: torch.dtype) -> PlainConvUNet:
    """A copy with every float32 parameter cast to `dtype` (the reference
    casts the parameter pytree the same way)."""
    if all(p.dtype == dtype for p in model.parameters()):
        return model
    return copy.deepcopy(model).to(dtype)


@torch.no_grad()
def unet_infer(model: PlainConvUNet, x: torch.Tensor,
               compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Inference entry: casts to the compute dtype, returns fp32 logits."""
    return cast_model(model, compute_dtype)(x.to(compute_dtype)).float()
