"""Per-volume orchestration: one TotalSegmentator model over a CT.

Counterpart of `boa_tpu/inference/pipeline.py:predict_image` on the
single-model path with a real predictor: in-plane body crop on the host ->
upload once -> canonical RAS and an order-3 resample to the model grid on
the device -> sliding-window prediction -> (optional) blob postprocessing
on the host -> order-0 back-resample and inverse orientation -> pad back to
the input grid. Not ported yet: multi-model merges, crop masks, the
fake-predict hook, statistics, nnU-Net-style one-hot back-resampling and
probability export.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from boa_tpu_torch.device import resolve_device
from boa_tpu_torch.inference.predictor import Predictor, load_stacked_cached
from boa_tpu_torch.io import nifti
from boa_tpu_torch.io.nifti import NiftiImage
from boa_tpu_torch.ops import cropping, packing
from boa_tpu_torch.ops import postprocessing as pped
from boa_tpu_torch.ops import resample as rs
from boa_tpu_torch.tasks import class_maps
from boa_tpu_torch.tasks.registry import resolve_task

_CLASS_MAP_KEY = {"total_fast": "total"}


@dataclass
class PredictImageResult:
    seg: NiftiImage                    # labels on the input grid
    seg_model_grid: NiftiImage | None  # labels on the model grid
    label_map: dict[int, str] = field(default_factory=dict)


class _Spans:
    """Per-stage wall seconds into `out` (when given); each mark waits for
    the device so a stage's time is its own."""

    def __init__(self, out: dict | None, device: torch.device) -> None:
        self.out, self.device = out, device
        self.t = time.perf_counter()

    def mark(self, label: str) -> None:
        if self.out is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.out[label] = self.out.get(label, 0.0) + now - self.t
        self.t = now


def _canonical_crop_axes(ci, ornt: np.ndarray) -> tuple[list, list]:
    """(full canonical shape, crop offsets) of an in-plane body crop."""
    lo = (ci.x0, ci.y0, 0)
    hi = (ci.x1, ci.y1, int(ci.orig_shape[2]))
    full_c, off_c = [0, 0, 0], [0, 0, 0]
    for i in range(3):
        p = int(ornt[i, 0])
        ext = int(ci.orig_shape[i])
        full_c[p] = ext
        off_c[p] = (ext - hi[i]) if ornt[i, 1] < 0 else lo[i]
    return full_c, off_c


def predict_image(img: NiftiImage, task_name: str, store, *, fast: bool = False,
                  folds=None, step_size: float | None = None,
                  compute_dtype: str = "bfloat16", device=None,
                  spans: dict | None = None) -> PredictImageResult:
    """Run one model family over a CT volume; the result is on the input
    grid. `device` defaults to the card. `spans`, when given, receives the
    wall seconds of each stage and the tile count ("tiles")."""
    device = resolve_device(device)
    task = resolve_task(task_name, fast=fast)
    if len(task.task_ids) > 1:
        raise NotImplementedError("multi-model tasks are not ported yet; "
                                  "use fast=True")
    label_map = class_maps.get_class_map(_CLASS_MAP_KEY.get(task.name, task.name))
    if img.data.ndim > 3:
        img = NiftiImage(data=np.asarray(img.data)[..., 0], affine=img.affine)
    sp = _Spans(spans, device)

    # --- in-plane body crop (cached on the parent image for repeat calls)
    img_orig = img
    body_info = None
    if getattr(img, "crop_info", None) is None:
        cached = getattr(img, "_body_cropped", None)
        if cached is not None:
            img, body_info = cached
        else:
            cropped, body_info = cropping.body_crop_xy(img)
            if body_info is not None:
                object.__setattr__(img, "_body_cropped", (cropped, body_info))
                img = cropped
    sp.mark("body_crop")

    # --- upload once, canonical orientation and resample on the device
    ornt, canon_affine, canon_shape, canon_zooms = nifti.canonical_geometry(img)
    data_dev = nifti.apply_orientation_device(img.device_data(device), ornt)
    sp.mark("upload+orient")
    resample = task.resample
    if task.resample_only_thickness and resample is not None:
        resample = (canon_zooms[0], canon_zooms[1], resample[2])
    ci = getattr(img, "crop_info", None)
    crop_axes = None if ci is None else _canonical_crop_axes(ci, ornt)
    bwd_windows = None
    if resample is not None and not np.allclose(canon_zooms, resample):
        out_shape, zoom, new_spacing = rs.change_spacing_shape(
            canon_shape, canon_zooms, resample)
        fwd_windows = None
        rsp_affine = rs.rescale_affine(canon_affine, zoom)
        if crop_axes is not None:
            # windowed operators keep the cropped model grid an exact subgrid
            # of the uncropped one
            full_c, off_c = crop_axes
            full_out = rs.zoom_output_shape(full_c, zoom)
            out0 = [min(max(int(round(off_c[p] * float(zoom[p]))), 0),
                        full_out[p] - out_shape[p]) for p in range(3)]
            fwd_windows = tuple(
                None if (full_c[p] == canon_shape[p]
                         and full_out[p] == out_shape[p]) else
                (full_c[p], full_out[p], off_c[p], out0[p]) for p in range(3))
            bwd_windows = tuple(None if w is None else (w[1], w[0], w[3], w[2])
                                for w in fwd_windows)
            full_affine = np.copy(canon_affine)
            full_affine[:3, 3] = (canon_affine @ np.array(
                [-off_c[0], -off_c[1], -off_c[2], 1.0]))[:3]
            full_rsp = rs.rescale_affine(full_affine, zoom)
            rsp_affine = np.copy(full_rsp)
            rsp_affine[:3, 3] = (full_rsp @ np.array(
                [out0[0], out0[1], out0[2], 1.0]))[:3]
        data_rsp = rs.resample_volume(data_dev, out_shape, order=3,
                                      convention="zoom",
                                      windows=fwd_windows).to(torch.int32)
        rsp_spacing = tuple(float(s) for s in new_spacing)
    else:
        data_rsp = data_dev.to(torch.int32)
        rsp_affine = canon_affine
        rsp_spacing = canon_zooms
    sp.mark("resample")

    # --- step size heuristic (TotalSegmentator nnunet.py:507-514)
    if step_size is None:
        step_size = 0.8 if (task.name == "total" and task.resample is not None
                            and task.resample[0] < 3.0) else 0.5

    plans, models = load_stacked_cached(
        store, task.task_ids[0], task.trainer, task.model,
        folds if folds is not None else task.folds, device)
    sp.mark("load_weights")
    predictor = Predictor(plans=plans, models=models, tile_step_size=step_size,
                          compute_dtype=compute_dtype, device=device)
    seg_dev = predictor.predict(data_rsp, rsp_spacing,
                                return_device=True).to(torch.uint8)
    if spans is not None:
        spans["tiles"] = predictor.n_tiles
    sp.mark("predict")

    # --- labels to the host; postprocessing on the model grid
    seg_np = packing.download_labels(seg_dev)
    if task.keep_largest_blob:
        vox_vol = float(np.prod(rsp_spacing))
        seg_np = pped.keep_largest_blob_multilabel(seg_np, label_map,
                                                   ["body_trunc"])
        seg_np = pped.remove_small_blobs_multilabel(
            seg_np, label_map, ["body_extremities"],
            interval=(50000.0 / vox_vol, 1e10))
    seg_model_grid = NiftiImage(data=seg_np, affine=rsp_affine)
    sp.mark("download+postprocess")

    # --- back to the input grid: order-0 resample + inverse orientation
    inv = nifti.inv_orientation(ornt)
    rsp_shape = tuple(int(n) for n in data_rsp.shape)
    if resample is not None and rsp_shape != tuple(canon_shape) and \
            np.prod(rsp_shape) > np.prod(canon_shape):
        # a finer model grid: downsample on the device, move the small seg
        seg_canon = rs.resample_nearest(seg_dev, canon_shape,
                                        convention="zoom", windows=bwd_windows)
        seg_out_np = packing.download_labels(
            nifti.apply_orientation_device(seg_canon, inv))
    else:
        seg_canon_np = seg_np
        if resample is not None and seg_np.shape != tuple(canon_shape):
            seg_canon_np = rs.resample_nearest_host(
                seg_np, canon_shape, convention="zoom", windows=bwd_windows)
        seg_out_np = np.ascontiguousarray(nifti.apply_orientation(seg_canon_np,
                                                                  inv))
    if body_info is not None:
        seg_out_np = cropping.pad_back(seg_out_np, body_info)
    seg_out = NiftiImage(data=seg_out_np, affine=img_orig.affine.copy(),
                         crop_info=None if body_info is not None else ci)
    if seg_out.shape != img_orig.shape:
        raise RuntimeError(f"shape mismatch after pipeline: {seg_out.shape} "
                           f"vs {img_orig.shape}")
    seg_out.set_label_map(label_map)
    sp.mark("back_resample+pad")
    return PredictImageResult(seg=seg_out, seg_model_grid=seg_model_grid,
                              label_map=label_map)
