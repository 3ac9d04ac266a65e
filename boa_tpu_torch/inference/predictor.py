"""Per-model predictor: volume on the model grid -> label volume, on device.

Counterpart of `boa_tpu/inference/predictor.py` (`Predictor.predict` on its
fused path `_predict_seg_fused`, `_normalize_pad`, `load_stacked_cached`):
crop to the nonzero box, normalize each channel, pad to the patch, run the
Gaussian-fused sliding window with an argmax over the real classes, and put
the labels back into the uncropped grid. A volume that is not already on
the plan's grid (the predictor's own resample), `return_probabilities`,
cascade inputs and region-based plans are not ported yet and raise.
"""

from __future__ import annotations

import logging
from collections import OrderedDict
from dataclasses import dataclass

import numpy as np
import torch

from boa_tpu_torch.device import resolve_device
from boa_tpu_torch.inference.sliding_window import sliding_window_seg_chunked
from boa_tpu_torch.models.unet import ArchConfig, cast_model
from boa_tpu_torch.ops import preprocess as pp
from boa_tpu_torch.ops import resample as rs
from boa_tpu_torch.plans.plans import ModelPlans
from boa_tpu_torch.weights.convert import params_from_numpy

logger = logging.getLogger(__name__)

_DTYPES = {"float16": torch.float16, "float32": torch.float32,
           "bfloat16": torch.bfloat16}
_SCHEMES = ("CTNormalization", "ZScoreNormalization", "ZScore")


def _normalize_pad(vol: torch.Tensor, props: list[dict], pads, schemes
                   ) -> torch.Tensor:
    """Per-channel normalization + centred zero padding to the patch.

    vol (C, X, Y, Z); props: the plan's intensity properties per channel
    (used by CT channels only)."""
    v = torch.stack([pp.ct_normalize(vol[c], props[c]) if s == "CTNormalization"
                     else pp.zscore_normalize(vol[c]) for c, s in enumerate(schemes)])
    if any(p != (0, 0) for p in pads):
        flat = [q for (a, b) in reversed(pads) for q in (a, b)]
        v = torch.nn.functional.pad(v, flat)
    return v


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
    patch, else 1) as the default; it was tuned on a TPU and is a parameter
    here, not a measured choice."""

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
    device: object = None

    def __post_init__(self) -> None:
        self.cfg: ArchConfig = self.plans.arch_config()
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

    def _accum(self, padded_shape) -> torch.dtype:
        if self.accum_dtype == "auto":
            nbytes = 4 * self.cfg.num_classes * int(np.prod(padded_shape))
            return torch.float16 if nbytes > 2e9 else torch.float32
        return _DTYPES[self.accum_dtype]

    def _predict_seg_fused(self, dev: torch.Tensor, schemes) -> torch.Tensor:
        """(C, X, Y, Z) raw volume on the plan grid -> label volume."""
        spatial = tuple(dev.shape[-3:])
        patch = tuple(self.plans.patch_size_xyz)
        pads = []
        for n, p in zip(spatial, patch):
            d = max(p, n) - n
            pads.append((d // 2, d - d // 2))
        padded = tuple(n + a + b for n, (a, b) in zip(spatial, pads))
        starts = pp.tile_starts(padded, patch, self.tile_step_size)
        self.n_tiles = len(starts)
        gauss = (pp.gaussian_importance_map(patch) if self.use_gaussian
                 else np.ones(patch, np.float32))
        props = [self.plans.channel_intensity_properties(c)
                 for c in range(len(schemes))]
        v = _normalize_pad(dev, props, pads, schemes)
        tb = self.tile_batch
        if tb is None:
            z_pool = int(np.prod([s[2] for s in self.cfg.strides]))
            tb = 2 if (16 <= patch[2] <= 64 and z_pool >= 16
                       and not self.mirror_axes and len(starts) >= 2) else 1
        return sliding_window_seg_chunked(
            self._cast, v, starts, gauss, self.cfg.num_classes,
            mirror_axes=self.mirror_axes, compute_dtype=self._dtype,
            accum_dtype=self._accum(padded),
            seg_dtype=torch.uint8 if self.cfg.num_classes <= 255 else torch.int32,
            revert=tuple((b, b + n) for (b, _), n in zip(pads, spatial)),
            tile_batch=tb)

    def predict(self, vol_xyz, spacing_xyz, return_device: bool = False):
        """Label volume for a raw (X, Y, Z) or (C, X, Y, Z) volume at
        `spacing_xyz`, which must already be the plan's grid."""
        if self.plans.transpose_forward != [0, 1, 2]:
            raise NotImplementedError("non-identity transpose_forward")
        if self.plans.previous_stage is not None or self.plans.has_regions:
            raise NotImplementedError("cascade stages and region-based plans "
                                      "are not ported yet")
        dev = torch.as_tensor(vol_xyz).to(self.device, torch.float32)
        if dev.dim() == 3:
            dev = dev[None]
        n_ch = dev.shape[0]
        orig_shape = tuple(dev.shape[-3:])
        bbox = pp.bbox_array(dev)
        full_extent = bool((bbox[:, 0] == 0).all()
                           and (bbox[:, 1] == np.array(orig_shape)).all())
        box = tuple(slice(int(a), int(b)) for a, b in bbox)
        if not full_extent:
            dev = dev[(slice(None),) + box]
        schemes = tuple((self.plans.normalization_schemes * n_ch)[:n_ch])
        new_shape = rs.compute_new_shape(dev.shape[-3:], spacing_xyz,
                                         self.plans.spacing_xyz)
        if tuple(new_shape) != tuple(dev.shape[-3:]) or \
                not all(s in _SCHEMES for s in schemes):
            raise NotImplementedError(
                "only volumes already on the plan grid with CT / z-score "
                "normalization are ported so far")
        try:
            seg = self._predict_seg_fused(dev, schemes)
        except torch.cuda.OutOfMemoryError:
            # the reference retries with float16 accumulators on an HBM OOM
            if self.accum_dtype == "float16" or \
                    self._accum(dev.shape[-3:]) == torch.float16:
                raise
            logger.warning("sliding window ran out of device memory; "
                           "retrying with float16 accumulators")
            old = self.accum_dtype
            self.accum_dtype = "float16"
            try:
                seg = self._predict_seg_fused(dev, schemes)
            finally:
                self.accum_dtype = old
        if not full_extent:
            full = torch.zeros(orig_shape, dtype=seg.dtype, device=seg.device)
            full[box] = seg
            seg = full
        if return_device:
            return seg
        return seg.cpu().numpy().astype(
            np.uint8 if self.cfg.num_classes <= 255 else np.uint16)
