"""Per-model predictor: raw volume -> label volume, on device.

Counterpart of `boa_tpu/inference/predictor.py` (nnU-Net's
`nnUNetPredictor` as one device pipeline): crop to the nonzero box,
normalize each channel, and then one of two paths.

- Fused (the volume is already on the plan's grid, softmax labels, no
  probabilities, no cascade input): pad to the patch, run the
  Gaussian-fused sliding window with an argmax over the real classes.
- General: resample to the plan's spacing (order 3, 'resize', order 0
  along z when anisotropic), append a cascade stage's one-hot channels,
  take the weight-normalized sliding-window logits (`predict_logits`),
  resample them back (order 1) and take the argmax class-chunked, or paint
  sigmoid regions in `regions_class_order`; optionally softmax / sigmoid
  probabilities.

Either way the labels go back into the uncropped grid.

A 2d configuration (a 2-element patch) runs its per-slice net on the whole
slice stack: the "tile" spans the full z extent, the Gaussian is in-plane
and flat over z, the resample is in-plane only (no separate z) and the
output has the input's shape, as in the reference.
"""

from __future__ import annotations

import logging
from collections import OrderedDict
from dataclasses import dataclass

import numpy as np
import torch

from boa_tpu_torch.device import resolve_device
from boa_tpu_torch.inference.sliding_window import (sliding_window_logits,
                                                    sliding_window_seg_chunked)
from boa_tpu_torch.models.unet import ArchConfig, cast_model
from boa_tpu_torch.ops import preprocess as pp
from boa_tpu_torch.ops import resample as rs
from boa_tpu_torch.plans.plans import ModelPlans
from boa_tpu_torch.utils import timing
from boa_tpu_torch.weights.convert import params_from_numpy

logger = logging.getLogger(__name__)

_DTYPES = {"float16": torch.float16, "float32": torch.float32,
           "bfloat16": torch.bfloat16}
_SCHEMES = ("CTNormalization", "ZScoreNormalization", "ZScore")
ANISO_THRESHOLD = 3.0  # nnU-Net's anisotropy threshold


def determine_separate_z(current_spacing, new_spacing,
                         threshold: float = ANISO_THRESHOLD):
    """(do_separate_z, axis): nnU-Net resamples an anisotropic volume in
    plane and along its one coarse axis separately."""

    def _sep(sp):
        return (np.max(sp) / np.min(sp)) > threshold

    def _axis(sp):
        return np.where(np.max(sp) / np.array(sp) == 1)[0]

    if _sep(current_spacing):
        axis = _axis(current_spacing)
    elif _sep(new_spacing):
        axis = _axis(new_spacing)
    else:
        return False, None
    if len(axis) != 1:
        return False, None
    return True, int(axis[0])


def _argmax_resampled(logits: torch.Tensor, target_shape, sep_z) -> torch.Tensor:
    """argmax over classes of the order-1 ('resize') resampled logits, 8
    classes at a time (`resample.argmax_chunked`), so the full-resolution
    logits never exist at once. int64 labels."""
    return rs.argmax_chunked(
        lambda c0, c1: rs.resample_volume(logits[c0:c1].float(), target_shape,
                                          order=1, convention="resize",
                                          separate_z_order=sep_z),
        logits.shape[0])


def _pads(spatial, patch, bucket: int | None) -> list[tuple[int, int]]:
    """Centred zero padding up to the patch, then up to a multiple of
    `bucket` voxels per axis when given."""
    pads = []
    for n, p in zip(spatial, patch):
        target = max(p, n)
        if bucket:
            target = -(-target // bucket) * bucket
        d = target - n
        pads.append((d // 2, d - d // 2))
    return pads


def _pad(v: torch.Tensor, pads) -> torch.Tensor:
    if all(p == (0, 0) for p in pads):
        return v
    return torch.nn.functional.pad(v, [q for (a, b) in reversed(pads) for q in (a, b)])


def _paint_regions(logits: torch.Tensor, order, dt) -> torch.Tensor:
    """Sigmoid heads to labels: region i paints class order[i] where its
    logit is > 0 (sigmoid > 0.5), later regions over earlier ones."""
    seg = torch.zeros(logits.shape[1:], dtype=dt, device=logits.device)
    for i, c in enumerate(order):
        seg = torch.where(logits[i] > 0.0, torch.tensor(c, dtype=dt,
                                                        device=seg.device), seg)
    return seg


def _normalize(vol: torch.Tensor, props: list[dict], schemes) -> torch.Tensor:
    """Per-channel normalization of a (C, X, Y, Z) volume; props: the plan's
    intensity properties per channel (used by CT channels only)."""
    chans = []
    for c, s in enumerate(schemes):
        if s == "CTNormalization":
            chans.append(pp.ct_normalize(vol[c], props[c]))
        elif s in _SCHEMES:
            chans.append(pp.zscore_normalize(vol[c]))
        else:
            raise ValueError(f"unknown normalization scheme {s!r}")
    return torch.stack(chans)


# --- device-resident weight cache: the fold models of a checkpoint stay on
#     the card across studies, keyed on the checkpoint files' stamp
_STACKED_CACHE: OrderedDict = OrderedDict()
CACHE_BUDGET_BYTES = 6e9


def load_stacked_cached(store, task_id: int, trainer: str, model: str, folds,
                        device=None) -> tuple[ModelPlans, list]:
    """(plans, [one float32 PlainConvUNet per fold on `device`]), cached."""
    device = resolve_device(device)
    mdir = store.model_dir(task_id, trainer, model=model)
    if folds is None:
        folds = sorted(int(p.name.split("_")[1]) for p in mdir.glob("fold_*"))
    stamp = []
    for f in folds:
        p = mdir / f"fold_{f}" / "checkpoint_final.npz"
        if p.exists():
            st = p.stat()
            stamp.append((f, st.st_mtime_ns, st.st_size))
    key = (str(store.root), task_id, trainer, model, tuple(folds), str(device),
           tuple(stamp))
    hit = _STACKED_CACHE.get(key)
    if hit is not None:
        _STACKED_CACHE.move_to_end(key)
        return hit[0], hit[1]
    plans, params = store.load(task_id, trainer=trainer, model=model,
                               folds=folds)
    cfg = plans.arch_config()
    models = [params_from_numpy(p, cfg, device) for p in params]
    nbytes = sum(p.numel() * p.element_size() for m in models
                 for p in m.parameters())
    for stale in [k for k in _STACKED_CACHE if k[:6] == key[:6]]:
        del _STACKED_CACHE[stale]  # same model, outdated checkpoint files
    _STACKED_CACHE[key] = (plans, models, nbytes)
    total = sum(v[2] for v in _STACKED_CACHE.values())
    while total > CACHE_BUDGET_BYTES and len(_STACKED_CACHE) > 1:
        _, evicted = _STACKED_CACHE.popitem(last=False)
        total -= evicted[2]
    return plans, models


@dataclass
class Predictor:
    """Fold-ensemble sliding-window predictor for one model.

    Give either `models` (PlainConvUNet per fold) or `fold_params` (numpy
    parameter pytrees in the reference's layout). `tile_batch=None` keeps the
    reference's rule (2 tiles per forward for z-pooling archs with a small-z
    patch, else 1) as the default on the fused path; it was tuned on a TPU
    and is a parameter here, not a measured choice. `bucket` pads the
    volume up to multiples of `bucket` voxels per axis (the same centred
    zero padding that reaches the patch), transparently to the caller."""

    plans: ModelPlans
    models: list | None = None
    fold_params: list | None = None
    tile_step_size: float = 0.5
    use_gaussian: bool = True
    mirror_axes: tuple[int, ...] = ()
    compute_dtype: str = "bfloat16"
    # "auto": float32 until the logit volume would pass ~2 GB, then float16
    accum_dtype: str = "auto"
    tile_batch: int | None = None
    bucket: int | None = None
    device: object = None

    def __post_init__(self) -> None:
        self.cfg: ArchConfig = self.plans.arch_config()
        self.two_d = len(self.plans.patch_size) == 2
        self.device = resolve_device(self.device)
        self._dtype = _DTYPES[self.compute_dtype]
        if self.models is None:
            if self.fold_params is None:
                raise ValueError("Predictor needs models or fold_params")
            self.models = [params_from_numpy(p, self.cfg, self.device)
                           for p in self.fold_params]
        self._cast = [cast_model(m.to(self.device), self._dtype)
                      for m in self.models]
        self.n_tiles = 0  # tiles of the last prediction
        self.accum_used: torch.dtype | None = None  # its accumulator dtype

    def _accum(self, padded_shape) -> torch.dtype:
        if self.accum_dtype == "auto":
            nbytes = 4 * self.cfg.num_classes * int(np.prod(padded_shape))
            return torch.float16 if nbytes > 2e9 else torch.float32
        return _DTYPES[self.accum_dtype]

    def _use_accum(self, padded_shape) -> torch.dtype:
        self.accum_used = self._accum(padded_shape)
        return self.accum_used

    def _patch3(self, spatial) -> tuple[int, int, int]:
        """The tile: the plan's patch, or for a 2d plan its in-plane patch
        over the whole z extent."""
        p = tuple(self.plans.patch_size_xyz)
        return p if not self.two_d else (p[0], p[1], int(spatial[2]))

    def _gauss(self, patch) -> torch.Tensor:
        """Fusion weights of one tile on the device; for a 2d plan the
        in-plane Gaussian broadcast (not copied) over z."""
        if not self.use_gaussian:
            return torch.ones(patch, dtype=torch.float32, device=self.device)
        if not self.two_d:
            return torch.as_tensor(pp.gaussian_importance_map(patch), device=self.device)
        g2 = pp.gaussian_importance_map((patch[0], patch[1], 1))
        return torch.as_tensor(g2, device=self.device).expand(patch)

    def _with_fp16_retry(self, run, shape):
        """run(); on a device out-of-memory error with float32 accumulators,
        once more with float16 ones (the reference's retry)."""
        try:
            return run()
        except torch.cuda.OutOfMemoryError:
            if self.accum_dtype == "float16" or self._accum(shape) == torch.float16:
                raise
            logger.warning("sliding window ran out of device memory; "
                           "retrying with float16 accumulators")
            old = self.accum_dtype
            self.accum_dtype = "float16"
            try:
                return run()
            finally:
                self.accum_dtype = old

    # ------------------------------------------------------------------
    def predict_logits(self, vol_cxyz) -> torch.Tensor:
        """Weight-normalized sliding-window logits (classes, X, Y, Z), in the
        accumulator dtype, of an already-normalized (C, X, Y, Z) volume."""
        vol = torch.as_tensor(vol_cxyz).to(self.device, torch.float32)
        spatial = tuple(vol.shape[-3:])
        patch = self._patch3(spatial)
        pads = _pads(spatial, patch, self.bucket)
        vol = _pad(vol, pads)
        padded = tuple(vol.shape[-3:])
        starts = pp.tile_starts(padded, patch, self.tile_step_size)
        self.n_tiles = len(starts)
        logits = self._with_fp16_retry(lambda: sliding_window_logits(
            self._cast, vol, starts, self._gauss(patch), self.cfg.num_classes,
            mirror_axes=self.mirror_axes, compute_dtype=self._dtype,
            accum_dtype=self._use_accum(padded)), padded)
        return logits[(slice(None),) + tuple(slice(b, b + n)
                                             for (b, _), n in zip(pads, spatial))]

    # ------------------------------------------------------------------
    def _predict_seg_fused(self, dev: torch.Tensor, schemes) -> torch.Tensor:
        """(C, X, Y, Z) raw volume on the plan grid -> label volume."""
        spatial = tuple(dev.shape[-3:])
        patch = self._patch3(spatial)
        pads = _pads(spatial, patch, self.bucket)
        padded = tuple(n + a + b for n, (a, b) in zip(spatial, pads))
        starts = pp.tile_starts(padded, patch, self.tile_step_size)
        self.n_tiles = len(starts)
        props = [self.plans.channel_intensity_properties(c)
                 for c in range(len(schemes))]
        v = _pad(_normalize(dev, props, schemes), pads)
        tb = self.tile_batch
        if tb is None:
            z_pool = int(np.prod([s[2] for s in self.cfg.strides]))
            tb = 2 if (16 <= patch[2] <= 64 and z_pool >= 16
                       and not self.mirror_axes and len(starts) >= 2) else 1
        with timing.span("window", self.device):
            return sliding_window_seg_chunked(
                self._cast, v, starts, self._gauss(patch), self.cfg.num_classes,
                mirror_axes=self.mirror_axes, compute_dtype=self._dtype,
                accum_dtype=self._use_accum(padded),
                seg_dtype=torch.uint8 if self.cfg.num_classes <= 255 else torch.int32,
                revert=tuple((b, b + n) for (b, _), n in zip(pads, spatial)),
                tile_batch=tb)

    # ------------------------------------------------------------------
    def predict(self, vol_xyz, spacing_xyz, return_device: bool = False,
                return_probabilities: bool = False, prev_seg_xyz=None):
        """Label volume for a raw (X, Y, Z) or (C, X, Y, Z) volume at
        `spacing_xyz`, on the same grid: uint8 (uint16 past 255 classes) on
        the host, or the device tensor with `return_device`.

        `prev_seg_xyz`, a cascade stage's input: the previous stage's labels
        on the same grid, cropped and resampled with the data and appended
        as one one-hot channel per foreground label. `return_probabilities`
        returns `(seg, probs)`, probs float16 (classes, X, Y, Z) softmax
        (sigmoid for region plans) of the logits resampled back to the
        input grid; it takes the general path."""
        if self.plans.transpose_forward != [0, 1, 2]:
            raise NotImplementedError("non-identity transpose_forward (ROADMAP "
                                      "Queue 3, watch list)")
        if self.plans.previous_stage is not None and prev_seg_xyz is None:
            raise ValueError(
                f"configuration {self.plans.configuration_name!r} is a cascade "
                f"stage: it needs the previous stage "
                f"({self.plans.previous_stage!r}) segmentation as prev_seg_xyz")
        dev = torch.as_tensor(vol_xyz).to(self.device, torch.float32)
        if dev.dim() == 3:
            dev = dev[None]
        n_ch = dev.shape[0]
        orig_shape = tuple(dev.shape[-3:])
        prev = None
        if prev_seg_xyz is not None:
            prev = torch.as_tensor(prev_seg_xyz).to(self.device)
            if tuple(prev.shape) != orig_shape:
                raise ValueError(f"prev-stage seg shape {tuple(prev.shape)} != "
                                 f"input grid {orig_shape}")

        # 1. crop to the nonzero box over all channels
        bbox = pp.bbox_array(dev)
        full_extent = bool((bbox[:, 0] == 0).all()
                           and (bbox[:, 1] == np.array(orig_shape)).all())
        box = tuple(slice(int(a), int(b)) for a, b in bbox)
        if not full_extent:
            dev = dev[(slice(None),) + box]
            if prev is not None:
                prev = prev[box]
        shape0 = tuple(dev.shape[-3:])
        schemes = tuple((self.plans.normalization_schemes * n_ch)[:n_ch])
        cur_sp = np.array(spacing_xyz, dtype=np.float64)
        plan_sp = tuple(self.plans.spacing_xyz)
        if self.two_d:  # in-plane only: z stays native
            plan_sp = (plan_sp[0], plan_sp[1], float(spacing_xyz[2]))
        tgt_sp = np.array(plan_sp, dtype=np.float64)
        new_shape = tuple(rs.compute_new_shape(shape0, cur_sp, tgt_sp))
        n_cls = self.cfg.num_classes
        dt = torch.uint8 if n_cls <= 255 else torch.int32
        regions = self.plans.regions_class_order if self.plans.has_regions else None
        if self.plans.has_regions and regions is None:
            raise ValueError("region-based plans need regions_class_order in "
                             "dataset.json")

        probs = None
        if (new_shape == shape0 and regions is None and not return_probabilities
                and prev is None and all(s in _SCHEMES for s in schemes)):
            # 2. fused path: already on the plan grid, softmax labels
            seg_c = self._with_fp16_retry(
                lambda: self._predict_seg_fused(dev, schemes), shape0)
        else:
            # 2. normalize, then resample to the plan spacing (order 3,
            #    order 0 along z when anisotropic)
            props = [self.plans.channel_intensity_properties(c) for c in range(n_ch)]
            v = _normalize(dev, props, schemes)
            do_sep, axis = ((False, None) if self.two_d
                            else determine_separate_z(cur_sp, tgt_sp))
            sep_z = 0 if (do_sep and axis == 2) else None
            resampled = new_shape != shape0
            if resampled:
                v = rs.resample_volume(v, new_shape, order=3, convention="resize",
                                       separate_z_order=sep_z)
            # 3. cascade input: the previous stage's labels one-hot
            if prev is not None:
                if resampled:
                    prev = rs.resample_nearest(prev, new_shape, convention="resize")
                fg = torch.tensor(self.plans.foreground_labels, device=prev.device)
                v = torch.cat([v, (prev[None] == fg.view(-1, 1, 1, 1)).float()])
            # 4. sliding-window logits
            logits = self.predict_logits(v)
            # 5. back to the cropped input grid (order 1) and to labels
            if return_probabilities or regions is not None:
                if resampled:
                    logits = rs.resample_volume(logits.float(), shape0, order=1,
                                                convention="resize",
                                                separate_z_order=sep_z)
                if regions is not None:
                    seg_c = _paint_regions(logits, regions, dt)
                else:
                    seg_c = torch.argmax(logits, dim=0).to(dt)
                if return_probabilities:
                    f = logits.float()
                    probs = (torch.sigmoid(f) if regions is not None
                             else torch.softmax(f, dim=0)).to(torch.float16)
            elif resampled:
                seg_c = _argmax_resampled(logits, shape0, sep_z).to(dt)
            else:
                seg_c = torch.argmax(logits, dim=0).to(dt)

        # 6. back into the uncropped grid
        seg = seg_c
        if not full_extent:
            seg = torch.zeros(orig_shape, dtype=seg_c.dtype, device=seg_c.device)
            seg[box] = seg_c
            if probs is not None:
                full = torch.zeros((probs.shape[0],) + orig_shape,
                                   dtype=probs.dtype, device=probs.device)
                full[(slice(None),) + box] = probs
                probs = full
        if not return_device:
            seg = seg.cpu().numpy().astype(np.uint8 if n_cls <= 255 else np.uint16)
            if probs is not None:
                probs = probs.cpu().numpy()
        return seg if probs is None else (seg, probs)
