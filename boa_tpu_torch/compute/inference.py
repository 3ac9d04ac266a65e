"""Model runs over one CT study, from the CT file to the segmentation,
statistics, measurement and BCA files.

Counterpart of `boa_tpu/compute/inference.py` (body_organ_analysis
`compute/inference.py` `compute_all_models`): the CT is decoded once and
cropped to the body in plane, and the same image feeds every model.
TotalSegmentator tasks: crop-cascade tasks first run a low-res `total`;
`total`'s labels stay on the device for the measurement engine; each task's
labels go to `{output name}.nii.gz` (padded back to the full grid),
`total`'s statistics to `total-statistics.json`, and the measurements to
`total-measurements.json` and `ct_pfav.nii.gz`. The BCA models
(`BASE_MODELS`): `bca` runs `bca/pipeline.py:run_pipeline` with `total`'s
labels of this run (and writes `report.pdf` unless `save_pdf=False`),
`body_parts` and `body_regions` alone run `bca_inference`. With
`preview`, `total`'s labels on the card give `preview_total.png`
(`compute/preview.py`); a failed preview is logged as a warning and the
study goes on, as in the reference.
"""

from __future__ import annotations

import json
import logging
import pathlib
from typing import Any, Iterable

import numpy as np

from boa_tpu_torch.bca.pipeline import bca_inference, run_pipeline
from boa_tpu_torch.compute.preview import generate_preview
from boa_tpu_torch.device import resolve_device
from boa_tpu_torch.inference.pipeline import predict_image
from boa_tpu_torch.io import nifti
from boa_tpu_torch.measure.measurements import compute_measurements
from boa_tpu_torch.ops.connected_components import minmax
from boa_tpu_torch.ops.cropping import body_crop_xy
from boa_tpu_torch.utils.constants import BASE_MODELS
from boa_tpu_torch.utils.misc import (ADDITIONAL_MODELS_OUTPUT_NAME,
                                      convert_resampling_slices, np_json_default)
from boa_tpu_torch.utils.timing import Spans
from boa_tpu_torch.weights.store import ModelStore

logger = logging.getLogger(__name__)


def range_warning(ct_image_data: np.ndarray) -> tuple[float, float]:
    """(min, max) of the CT, with a warning when it leaves [-1024, 3071]."""
    lo, hi = minmax(ct_image_data)
    if lo < -1024 or hi > 3071:
        logger.warning(
            "Unexpected CT values found in input image: got %s-%s, expected "
            "-1024-3071. The values have been clipped to the expected range. "
            "Please check the segmentations to ensure that everything is "
            "correct.", lo, hi)
    return lo, hi


# tasks that run a cheap low-res `total` first and crop to specific organs
# (TotalSegmentator's crop cascade)
_CROP_TASKS = {"lung_vessels", "cerebral_bleed", "hip_implant",
               "liver_vessels", "pleural_pericard_effusion",
               "heartchambers_highres", "coronary_arteries", "liver_segments"}


def _output_name(model: str) -> str:
    return ADDITIONAL_MODELS_OUTPUT_NAME.get(model, model)


def compute_all_models(
    ct_path: pathlib.Path,
    segmentation_folder: pathlib.Path,
    models_to_compute: Iterable[str],
    totalsegmentator_params: dict[str, Any] | None = None,
    fast_bca: bool = False,
    bca_params: dict[str, Any] | None = None,
    force_split_threshold: int = 400,
    recompute: bool = True,
    cnr_adjustment: bool = True,
    store=None,
    fake_predict=None,
    worker=None,
    images_out: dict[str, Any] | None = None,
    device=None,
    spans: dict | None = None,
) -> dict[str, int]:
    """Returns the study's voxel and slice counts and writes its files.

    `store` defaults to `ModelStore()` (`$BOA_WEIGHTS_PATH`).
    `totalsegmentator_params` may hold `fast` (for `total`), `preview` and
    `license_number` (unused). `fast_bca` runs the BCA models on fold 0
    only; `bca_params` go to `run_pipeline` (`save_pdf`, the default, writes
    `report.pdf`). `force_split_threshold` only logs: the
    study is never split in z. `recompute=False` skips a task whose file
    exists, and the measurements when their file exists. `worker`
    (utils/stages.HostWorker) runs the file saves behind the next device
    stage, and the renders; every file is written before this returns
    (a preview render that failed there is logged). `images_out` collects
    the label images by task. `device` defaults to the card. `spans`, when
    given, receives the seconds of `load`, `body_crop`, every stage of
    `predict_image` (`predict_{tid}`, `statistics`, ...), the measurement
    engine's, `run_pipeline`'s, `preview_fronts` and `preview_render`
    (`generate_preview`), `save` (the files written on this thread, or
    handed to the worker) and `save_wait` (for the worker's saves and
    renders at the end)."""
    models_to_compute = list(models_to_compute)
    bca_params = dict(bca_params or {})
    totalsegmentator_params = dict(totalsegmentator_params or {})
    with_preview = totalsegmentator_params.pop("preview", False)
    fast_total = totalsegmentator_params.pop("fast", False)
    totalsegmentator_params.pop("license_number", None)
    if totalsegmentator_params:
        raise TypeError(f"unknown totalsegmentator_params {sorted(totalsegmentator_params)}")
    device = resolve_device(device)
    store = store or ModelStore()
    sp = Spans(spans, device)
    segmentation_folder = pathlib.Path(segmentation_folder)
    segmentation_folder.mkdir(parents=True, exist_ok=True)

    ct_img = nifti.load(pathlib.Path(ct_path))
    if ct_img.data.ndim != 3:
        raise ValueError(f"Only 3D CT scans are supported not {ct_img.data.ndim}D.")
    logger.info("Input image %s: size %s, spacing %s", ct_path, ct_img.shape, ct_img.zooms)
    range_warning(np.asarray(ct_img.data))
    shape, spacing = ct_img.shape, ct_img.zooms
    sp.mark("load")
    # in-plane body crop before the first upload; saved volumes are padded
    # back to the full grid
    ct_img, _ = body_crop_xy(ct_img)
    sp.mark("body_crop")
    stats = {
        "num_voxels": int(shape[0]) * int(shape[1]) * int(shape[2]),
        "num_slices": int(shape[2]),
        "num_slices_resampled": convert_resampling_slices(
            slices=shape[-1], current_sampling=spacing[-1], target_resampling=1.5),
    }

    crop_total: nifti.NiftiImage | None = None  # the low-res total of the cascade
    save_futures: list = []
    seg_cache: dict[str, nifti.NiftiImage] = images_out if images_out is not None else {}
    measurement_models = [m for m in models_to_compute if m not in BASE_MODELS]
    for chosen_task in measurement_models:
        seg_file = segmentation_folder / f"{_output_name(chosen_task)}.nii.gz"
        if not recompute and seg_file.is_file():
            logger.info("Model %s was already computed, skipping", chosen_task)
            continue

        crop_mask = None
        if chosen_task in _CROP_TASKS and fake_predict is None:
            from boa_tpu_torch.tasks.registry import get_task

            task_cfg = get_task(chosen_task)
            if task_cfg.crop:
                if crop_total is None:
                    crop_res = predict_image(ct_img, "total", store, fast=True,
                                             device=device, spans=spans)
                    crop_total = crop_res.seg
                inv = {v: k for k, v in crop_total.get_label_map().items()}
                labels = [inv[o] for o in task_cfg.crop if o in inv]
                mask = np.isin(np.asarray(crop_total.data), labels)
                crop_mask = nifti.NiftiImage(data=mask.astype(np.uint8),
                                             affine=crop_total.affine)

        res = predict_image(
            ct_img, chosen_task, store,
            fast=fast_total if chosen_task == "total" else False,
            crop_mask=crop_mask, statistics=chosen_task == "total",
            fake_predict=fake_predict, keep_device_seg=chosen_task == "total",
            device=device, spans=spans)
        sp.restart()
        seg_cache[chosen_task] = res.seg
        if res.seg_dev_full is not None:
            # seed the image's device cache (io/nifti.py device_data), so
            # that the measurement engine reuses these labels
            object.__setattr__(res.seg, "_device_data",
                               (res.seg.data, device, res.seg_dev_full))
        if worker is not None:
            save_futures.append(worker.submit(
                f"save-{seg_file.name}", nifti.save, res.seg, seg_file))
        else:
            nifti.save(res.seg, seg_file)
        if res.stats is not None:
            with (segmentation_folder / f"{chosen_task}-statistics.json").open("w") as f:
                json.dump(res.stats, f, indent=2, default=np_json_default)
        sp.mark("save")
        if with_preview and chosen_task == "total":
            try:
                fut = generate_preview(ct_img, res.seg, res.label_map,
                                       segmentation_folder / "preview_total.png",
                                       worker=worker, device=device, spans=spans)
                if fut is not None:
                    save_futures.append(fut)
            except Exception:
                logger.warning("Preview generation failed", exc_info=True)
            sp.restart()

    measurement_file = segmentation_folder / "total-measurements.json"
    if measurement_models and (recompute or not measurement_file.is_file()):
        json_data = compute_measurements(
            ct_path=pathlib.Path(ct_path), segmentation_folder=segmentation_folder,
            models=measurement_models, cnr_adjustment=cnr_adjustment,
            ct_image=ct_img, seg_images=seg_cache, worker=worker,
            device=device, spans=spans, save_futures=save_futures)
        sp.restart()
        with measurement_file.open("w") as f:
            json.dump(json_data, f, indent=2, default=np_json_default)
        sp.mark("save")
    else:
        logger.info("The total measurements were already computed, skipping")

    for boa_task in sorted(BASE_MODELS & set(models_to_compute)):
        resampling_bca = convert_resampling_slices(
            slices=shape[-1], current_sampling=spacing[-1], target_resampling=5.0)
        if resampling_bca > force_split_threshold:
            logger.info("Study resamples to %s slices (> %s); the reference would "
                        "split it in z, this pipeline does not.",
                        resampling_bca, force_split_threshold)
        if boa_task == "bca":
            run_pipeline(input_image=ct_img, output_dir=segmentation_folder, store=store,
                         fast_bca=fast_bca, recompute=recompute, fake_predict=fake_predict,
                         total_seg=np.asarray(seg_cache["total"].data)
                         if "total" in seg_cache else None,
                         worker=worker, stats_out=stats, images_out=images_out,
                         device=device, spans=spans, **bca_params)
        else:
            bca_inference(ct_img, segmentation_folder, boa_task, store, fast_bca,
                          recompute=recompute, fake_predict=fake_predict, device=device,
                          spans=spans)
        sp.restart()
    for fut in save_futures:
        fut.result()
    sp.mark("save_wait")
    return stats
