"""Per-volume orchestration: one TotalSegmentator task over a CT.

Counterpart of `boa_tpu/inference/pipeline.py:predict_image`
(TotalSegmentator `nnUNet_predict_image`): crop to an organ mask (crop
cascade) or, for direct callers, crop the body in plane on the host ->
upload once -> canonical RAS and an order-3 resample to the task's grid on
the device -> one prediction per sub-model, merged into the task's label
space by a device LUT (later sub-models over earlier ones) -> strip
auxiliary labels, blob postprocessing on the host -> order-0 (or one-hot
order-1) back-resample and inverse orientation -> pad back / undo the crop
-> remove labels outside the dilated crop mask -> add one to the install's
prediction counter (utils/persistent_config.py). With `statistics=True`, the
per-class volumes and intensities on the model grid, from the device labels
and the resampled CT (measure/statistics.py).
"""

from __future__ import annotations

import logging
import pickle
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from boa_tpu_torch.device import resolve_device
from boa_tpu_torch.inference.predictor import Predictor, load_stacked_cached
from boa_tpu_torch.io import nifti, npz
from boa_tpu_torch.io.nifti import NiftiImage
from boa_tpu_torch.measure.statistics import get_basic_statistics
from boa_tpu_torch.ops import cropping, packing
from boa_tpu_torch.ops import postprocessing as pped
from boa_tpu_torch.ops import resample as rs
from boa_tpu_torch.tasks import class_maps
from boa_tpu_torch.tasks.registry import TaskConfig, resolve_task
from boa_tpu_torch.utils import timing
from boa_tpu_torch.utils.persistent_config import increase_prediction_counter
from boa_tpu_torch.utils.timing import Spans

logger = logging.getLogger(__name__)

# registry name -> class map key
_CLASS_MAP_KEY = {
    "total_fast": "total",
    "total_fastest": "total",
    "body_fast": "body",
    "total_mr_fast": "total_mr",
    "total_mr_fastest": "total_mr",
    "body_mr_fast": "body_mr",
    "lung_vessels": "lung_vessels",
}


def class_map_for_task(task_name: str) -> dict[int, str]:
    return class_maps.get_class_map(_CLASS_MAP_KEY.get(task_name, task_name))


@dataclass
class PredictImageResult:
    seg: NiftiImage                    # labels on the input grid
    seg_model_grid: NiftiImage | None  # labels on the model grid
    stats: dict | None = None          # statistics=True: {name: {volume, intensity}}
    label_map: dict[int, str] = field(default_factory=dict)
    # `seg.data` as a device tensor (keep_device_seg=True, no crop mask)
    seg_dev_full: torch.Tensor | None = None


def _empty_result(img: NiftiImage, label_map: dict[int, str]) -> PredictImageResult:
    out = NiftiImage(data=np.zeros(img.shape, np.uint8), affine=img.affine.copy())
    out.set_label_map(label_map)
    return PredictImageResult(seg=out, seg_model_grid=None, label_map=label_map)


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


def _part_lut(tid: int, inv: dict[str, int], to_part: bool) -> np.ndarray:
    """uint8 LUT between a sub-model's part labels and the task's labels
    (`inv`: name -> task label): part -> task, or task -> part."""
    part_map = class_maps.class_map_5_parts[class_maps.map_taskid_to_partname[tid]]
    if to_part:
        lut = np.zeros(max(inv.values()) + 1, np.uint8)
        for pid, name in part_map.items():
            lut[inv[name]] = pid
    else:
        lut = np.zeros(max(part_map) + 1, np.uint8)
        for pid, name in part_map.items():
            lut[pid] = inv[name]
    return lut


def predict_image(
    img: NiftiImage,
    task_name: str,
    store,
    *,
    fast: bool = False,
    crop_mask: NiftiImage | None = None,
    crop_addon_mm=None,
    folds=None,
    step_size: float | None = None,
    statistics: bool = False,
    compute_dtype: str = "bfloat16",
    bucket: int | None = None,
    nnunet_resampling: bool = False,
    fake_predict: Callable[[np.ndarray, tuple, int], np.ndarray] | None = None,
    remove_small_blobs: bool = False,
    save_probabilities=None,
    stats_aggregation: str = "mean",
    stats_normalized_intensities: bool = False,
    stats_exclude_border: bool = True,
    keep_device_seg: bool = False,
    device=None,
    spans: dict | None = None,
) -> PredictImageResult:
    """Run one task (one model, or the sub-models of `total`) over a CT; the
    result is on the input grid. `device` defaults to the card.

    fake_predict(vol_xyz, spacing_xyz, task_id) -> labels replaces the
    network (the reference's test hook); attributes on it: `run_real` runs
    the real predictor first and discards its labels, `total_space` makes
    one call with task id -1 give the merged labels of all sub-models,
    `wants_volume=False` passes a shape-only volume. remove_small_blobs
    drops components under 200 mm³ from every class on the model grid.
    save_probabilities writes the model grid's float16 class probabilities
    to this `.npz` path (+ a `.pkl` of properties), with a `_{task_id}`
    suffix per sub-model. keep_device_seg also returns the labels as a
    device tensor (`seg_dev_full`) where no crop mask is given.
    statistics=True returns `stats` of the postprocessed labels on the model
    grid: the `stats_aggregation` ("mean" or "median") HU of each class, of
    the min-max-normalized CT with `stats_normalized_intensities`, and 0 for
    a class on the 3-voxel margin with `stats_exclude_border`. `spans`,
    when given, receives the wall seconds of each stage (`predict_{tid}`
    per sub-model), the tile count of all sub-models ("tiles"), their tile
    forwards over every fold ("tile_forwards") and the number of them that
    accumulated in float16 ("float16_accumulators")."""
    device = resolve_device(device)
    task = resolve_task(task_name, fast=fast)
    label_map = class_map_for_task(task.name)
    max_label = int(max(label_map))
    if img.data.ndim > 3:
        img = NiftiImage(data=np.asarray(img.data)[..., 0], affine=img.affine)
    sp = Spans(spans, device)
    if crop_mask is not None and not np.asarray(crop_mask.data).any():
        return _empty_result(img, label_map)

    # --- crop to an organ mask from an earlier run (the crop cascade)
    img_orig = img
    bbox = None
    with sp.span("body_crop"):
        if crop_mask is not None:
            addon = crop_addon_mm if crop_addon_mm is not None else task.crop_addon
            img, bbox = cropping.crop_to_mask(img, crop_mask, addon_mm=addon,
                                              dtype=np.int32)

        # --- in-plane body crop for direct callers (cached on the parent image)
        body_info = None
        if crop_mask is None and getattr(img, "crop_info", None) is None:
            cached = getattr(img, "_body_cropped", None)
            if cached is not None:
                img, body_info = cached
            else:
                cropped, body_info = cropping.body_crop_xy(img)
                if body_info is not None:
                    object.__setattr__(img, "_body_cropped", (cropped, body_info))
                    img = cropped

    # --- upload once, canonical orientation and resample on the device
    with sp.span("upload+orient"):
        ornt, canon_affine, canon_shape, canon_zooms = nifti.canonical_geometry(img)
        data_dev = nifti.apply_orientation_device(img.device_data(device), ornt)
    with sp.span("resample"):
        resample = task.resample
        if task.resample_only_thickness and resample is not None:
            resample = (canon_zooms[0], canon_zooms[1], resample[2])
        ci = getattr(img, "crop_info", None)
        crop_axes = None if ci is None else _canonical_crop_axes(ci, ornt)
        bwd_windows = fake_geom = None
        if resample is not None and not np.allclose(canon_zooms, resample):
            out_shape, zoom, new_spacing = rs.change_spacing_shape(
                canon_shape, canon_zooms, resample)
            fwd_windows = None
            rsp_affine = rs.rescale_affine(canon_affine, zoom)
            if crop_axes is not None:
                # windowed operators keep the cropped model grid an exact subgrid
                # of the uncropped one (and the fake hook paints on the full grid)
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
                fake_geom = (tuple(int(n) for n in full_out), tuple(out0))
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
            if crop_axes is not None:  # unresampled: the crop is a subgrid already
                fake_geom = (tuple(int(n) for n in crop_axes[0]), tuple(crop_axes[1]))
        if fake_predict is None:
            fake_geom = None

    # --- step size heuristic (TotalSegmentator nnunet.py:507-514)
    if step_size is None:
        step_size = 0.8 if (task.name == "total" and task.resample is not None
                            and task.resample[0] < 3.0) else 0.5

    # --- one prediction per sub-model; merged into the task's labels by a
    #     LUT on the device, a later sub-model over an earlier one
    run = dict(task=task, folds=folds if folds is not None else task.folds,
               step_size=step_size, store=store, compute_dtype=compute_dtype,
               fake_predict=fake_predict, bucket=bucket, fake_geom=fake_geom,
               device=device, sp=sp)
    probs_base = None if save_probabilities is None else Path(save_probabilities)
    seg_host = seg_dev = None
    if len(task.task_ids) > 1:
        inv = {v: k for k, v in label_map.items()}
        fake_cache = {"inv": inv} if fake_predict is not None else None
        seg_dev = torch.zeros(tuple(data_rsp.shape), dtype=torch.uint8, device=device)
        for tid in task.task_ids:
            probs_path = None if probs_base is None else probs_base.with_name(
                probs_base.stem.split(".")[0] + f"_{tid}.npz")
            loaded = _load_weights(tid, run)
            with sp.span(f"predict_{tid}"):
                seg = _predict_one(data_rsp, rsp_spacing, tid, loaded,
                                   save_probabilities=probs_path, fake_cache=fake_cache,
                                   **run)
                with timing.span("merge", device):
                    part = torch.as_tensor(seg).to(device)
                    lut = torch.from_numpy(_part_lut(tid, inv, to_part=False)).to(device)
                    seg_dev = torch.where(part > 0, lut[part.long()], seg_dev)
    else:
        loaded = _load_weights(task.task_ids[0], run)
        with sp.span("predict"):
            seg_any = _predict_one(data_rsp, rsp_spacing, task.task_ids[0], loaded,
                                   save_probabilities=probs_base, **run)
            # the labels stay where they were made (the device for the real
            # predictor, the host for the fake hook) until a stage needs them
            if isinstance(seg_any, np.ndarray):
                seg_host = seg_any.astype(np.uint8, copy=False)
            else:
                seg_dev = seg_any.to(torch.uint8)

    def _seg_host() -> np.ndarray:
        nonlocal seg_host
        if seg_host is None:
            seg_host = packing.download_labels(seg_dev)
        return seg_host

    def _seg_dev() -> torch.Tensor:
        nonlocal seg_dev
        if seg_dev is None:
            seg_dev = packing.upload_labels(seg_host, max_label, device)
        return seg_dev

    with sp.span("download+postprocess"):
        # --- strip training-only auxiliary labels
        if task.name + "_auxiliary" in class_maps.class_map:
            seg_host, seg_dev = pped.remove_auxiliary_labels(_seg_host(), task.name), None

        # --- multilabel postprocessing on the model grid, on the host
        vox_vol = float(np.prod(rsp_spacing))
        if task.keep_largest_blob:
            seg_np = pped.keep_largest_blob_multilabel(_seg_host(), label_map,
                                                       ["body_trunc"])
            seg_host = pped.remove_small_blobs_multilabel(
                seg_np, label_map, ["body_extremities"],
                interval=(50000.0 / vox_vol, 1e10))
            seg_dev = None
        if remove_small_blobs:
            # drop components < 200 mm³ from every class (TotalSegmentator -rmb)
            seg_host = pped.remove_small_blobs_multilabel(
                _seg_host(), label_map, list(label_map.values()),
                interval=(200.0 / vox_vol, 1e10))
            seg_dev = None
        seg_model_grid = NiftiImage(data=_seg_host(), affine=rsp_affine)

    # --- statistics on the model grid, on the device
    stats = None
    if statistics:
        with sp.span("statistics"):
            stats = get_basic_statistics(
                _seg_dev(), data_rsp, rsp_spacing, label_map,
                exclude_masks_at_border=stats_exclude_border, metric=stats_aggregation,
                normalized_intensities=stats_normalized_intensities)

    with sp.span("back_resample+pad"):
        # --- back to the input grid: a finer model grid is downsampled on the
        #     device and the small seg moved; a coarser one moves first
        keep_dev = keep_device_seg and bbox is None and task.remove_outside is None
        inv_ornt = nifti.inv_orientation(ornt)
        rsp_shape = tuple(int(n) for n in data_rsp.shape)
        seg_out_dev = None
        if nnunet_resampling and resample is not None and rsp_shape != tuple(canon_shape):
            # one-hot order-1 per class + argmax (TotalSegmentator's
            # nnunet_resampling flag): smoother label borders
            seg_canon = rs.resample_seg_onehot(_seg_dev(), canon_shape, max_label + 1,
                                               order=1, convention="zoom",
                                               windows=bwd_windows)
            seg_out_dev = nifti.apply_orientation_device(seg_canon, inv_ornt)
            seg_out_np = packing.download_labels(seg_out_dev)
        elif resample is not None and rsp_shape != tuple(canon_shape) and \
                np.prod(rsp_shape) > np.prod(canon_shape):
            seg_canon = rs.resample_nearest(_seg_dev(), canon_shape,
                                            convention="zoom", windows=bwd_windows)
            seg_out_dev = nifti.apply_orientation_device(seg_canon, inv_ornt)
            seg_out_np = packing.download_labels(seg_out_dev)
        else:
            seg_canon_np = _seg_host()
            if resample is not None and seg_canon_np.shape != tuple(canon_shape):
                seg_canon_np = rs.resample_nearest_host(
                    seg_canon_np, canon_shape, convention="zoom", windows=bwd_windows)
            seg_out_np = np.ascontiguousarray(nifti.apply_orientation(seg_canon_np,
                                                                      inv_ornt))
            if keep_dev:
                # the same gathers on the device: bit-identical to the host copy
                sd = _seg_dev()
                if resample is not None and tuple(sd.shape) != tuple(canon_shape):
                    sd = rs.resample_nearest(sd, canon_shape, convention="zoom",
                                             windows=bwd_windows)
                seg_out_dev = nifti.apply_orientation_device(sd, inv_ornt)
        seg_out = NiftiImage(data=seg_out_np, affine=img.affine.copy(),
                             crop_info=None if body_info is not None else ci)
        if bbox is not None:
            seg_out = cropping.undo_crop(seg_out, img_orig, bbox)
        if body_info is not None:
            seg_out = NiftiImage(data=cropping.pad_back(seg_out.data, body_info),
                                 affine=img_orig.affine.copy())
            if keep_dev and seg_out_dev is not None:
                full = torch.zeros(img_orig.shape, dtype=seg_out_dev.dtype, device=device)
                full[body_info.x0:body_info.x1, body_info.y0:body_info.y1] = seg_out_dev
                seg_out_dev = full
        if seg_out.shape != img_orig.shape:
            raise RuntimeError(f"shape mismatch after pipeline: {seg_out.shape} "
                               f"vs {img_orig.shape}")

        # --- zero the labels outside the dilated crop mask (heartchambers_highres)
        if task.remove_outside is not None and crop_mask is not None:
            mm = task.remove_outside_dilation_mm or 10.0
            seg_out.data = pped.remove_outside_of_mask(
                np.asarray(seg_out.data), np.asarray(crop_mask.data) > 0,
                addon=max(1, int(mm / float(np.mean(img_orig.zooms)))))
        try:  # per-install prediction counter (utils/persistent_config.py)
            increase_prediction_counter()
        except Exception:  # bookkeeping never breaks a study
            logger.debug("prediction counter update failed", exc_info=True)
        seg_out.set_label_map(label_map)
    return PredictImageResult(seg=seg_out, seg_model_grid=seg_model_grid,
                              stats=stats, label_map=label_map,
                              seg_dev_full=seg_out_dev if keep_dev else None)


def _load_weights(task_id: int, run: dict):
    """(plans, stacked fold models) of one (sub-)model, in the span
    `load_weights`; None where the fake hook stands in for the network."""
    fake = run["fake_predict"]
    if fake is not None and not getattr(fake, "run_real", False):
        return None
    task = run["task"]
    with run["sp"].span("load_weights"):
        return load_stacked_cached(run["store"], task_id, task.trainer, task.model,
                                   run["folds"], run["device"])


def _predict_one(data_rsp: torch.Tensor, spacing, task_id: int, loaded, *,
                 task: TaskConfig, folds, step_size: float, store,
                 compute_dtype: str, fake_predict, bucket: int | None,
                 fake_geom: tuple | None, device: torch.device, sp: Spans,
                 save_probabilities: Path | None = None,
                 fake_cache: dict | None = None):
    """Labels of one (sub-)model on the model grid: a device tensor from the
    predictor on the `loaded` weights (`_load_weights`), a host array or
    device tensor from the fake hook."""

    def predictor() -> Predictor:
        plans, models = loaded
        return Predictor(plans=plans, models=models, tile_step_size=step_size,
                         compute_dtype=compute_dtype, bucket=bucket, device=device)

    if fake_predict is None:
        pred = predictor()
        if save_probabilities is not None:
            seg, probs = pred.predict(data_rsp, spacing, return_probabilities=True)
            _save_probabilities(probs, save_probabilities, spacing)
        else:
            seg = pred.predict(data_rsp, spacing, return_device=True)
        sp.add("tiles", pred.n_tiles)
        sp.add("tile_forwards", pred.n_tiles * len(pred.models))
        sp.add("float16_accumulators", int(pred.accum_used == torch.float16))
        return seg

    if getattr(fake_predict, "run_real", False):
        # run the real predictor for its cost, then let the fake supply the
        # labels (random weights give speckle, not anatomy)
        pred = predictor()
        pred.predict(data_rsp, spacing, return_device=True)
        sp.add("tiles", pred.n_tiles)
        sp.add("tile_forwards", pred.n_tiles * len(pred.models))
    full_shape = tuple(data_rsp.shape) if fake_geom is None else fake_geom[0]

    def window(seg: np.ndarray) -> np.ndarray:
        if fake_geom is None:
            return seg
        o, s = fake_geom[1], data_rsp.shape
        return seg[o[0]:o[0] + s[0], o[1]:o[1] + s[1], o[2]:o[2] + s[2]]

    if (fake_cache is not None and save_probabilities is None
            and getattr(fake_predict, "total_space", False)):
        # every sub-model's labels from ONE task-space fake: upload it once,
        # split into part labels on the device by an inverse LUT
        dev_total = fake_cache.get("dev_total")
        if dev_total is None:
            vol = np.broadcast_to(np.int32(0), full_shape)
            seg_total = window(np.asarray(fake_predict(vol, spacing, -1)))
            if seg_total.size and int(seg_total.max()) > 255:
                raise ValueError("a task-space fake must give labels <= 255")
            dev_total = packing.upload_labels(seg_total, 255, device)
            fake_cache["dev_total"] = dev_total
        lut = _part_lut(task_id, fake_cache["inv"], to_part=True)
        return torch.from_numpy(lut).to(device)[dev_total.long()]
    if getattr(fake_predict, "wants_volume", True):
        vol = data_rsp.cpu().numpy()
        if fake_geom is not None:  # re-embed in the full field of view as air
            full = np.full(full_shape, np.int32(-1024))
            o = fake_geom[1]
            full[o[0]:o[0] + vol.shape[0], o[1]:o[1] + vol.shape[1],
                 o[2]:o[2] + vol.shape[2]] = vol
            vol = full
    else:  # shape-only fakes skip the download
        vol = np.broadcast_to(np.int32(0), full_shape)
    seg = window(np.asarray(fake_predict(vol, spacing, task_id)))
    if save_probabilities is not None:  # one-hot stand-in probabilities
        probs = np.zeros((int(seg.max()) + 1,) + seg.shape, np.float16)
        np.put_along_axis(probs, seg[None].astype(np.int64), 1.0, axis=0)
        _save_probabilities(probs, save_probabilities, spacing)
    return seg


def _save_probabilities(probs: np.ndarray, path: Path, spacing) -> None:
    """`.npz` probabilities + a `.pkl` properties dict (nnU-Net's
    `--save_probabilities` pair); the properties hold the (z, y, x)
    spacing and the model-grid shape."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    npz.savez_compressed(path, probabilities=np.asarray(probs, np.float16))
    props = {"spacing": tuple(float(s) for s in spacing[::-1]),
             "shape_after_cropping_and_before_resampling":
                 tuple(int(n) for n in probs.shape[1:])}
    with open(path.with_suffix(".pkl"), "wb") as fh:
        pickle.dump(props, fh)
