"""The `totalsegmentator()` library call of the port.

Counterpart of `boa_tpu/python_api.py` (TotalSegmentator
`python_api.py:96-822`), with the reference's full keyword surface in its
positional order: task selection (task/fast/fastest), ml/per-class saving,
roi_subset (with the rough-segmentation crop pre-pass,
`python_api.py:673-736`), the body_seg pre-pass (`:739-750`), crop_path
reuse, statistics/radiomics, output_type nifti/dicom_seg/dicom_rtstruct
(`nnunet.py:737-786`), v1_order relabeling (`nnunet.py:383,704`), derived
body/skin masks (`nnunet.py:821-827`), remove_small_blobs, skip_saving,
save_probabilities and the test=N fake-inference hook
(`nnunet.py:560-578`).

Every model pass runs through `predict_image` on `device`: "gpu" (the
default, as upstream TotalSegmentator's), "cuda" or "gpu:N" is the card and
raises without CUDA; "cpu" is the host. The per-class NIfTI masks are
written by `nr_thr_saving` threads (the files are the reference's bytes).
"""

from __future__ import annotations

import functools
import json
import logging
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from boa_tpu_torch.device import named_device
from boa_tpu_torch.io import nifti
from boa_tpu_torch.io.nifti import NiftiImage
from boa_tpu_torch.tasks import class_maps
from boa_tpu_torch.tasks.registry import TASKS, get_task
from boa_tpu_torch.utils import timing
from boa_tpu_torch.utils.timing import Spans
from boa_tpu_torch.weights.store import ModelStore

logger = logging.getLogger(__name__)


def show_license_info() -> None:
    """`python_api.py:75-93`: explain how license-gated models unlock."""
    from boa_tpu_torch.utils.persistent_config import get_license_number

    if not get_license_number():
        print(
            "This model is only available for licensed users. Set your "
            "license with: python -m boa_tpu_torch.tools.set_license -l aca_...")
        raise SystemExit(1)


def _load_input(input):  # noqa: A002
    """(NiftiImage, DICOM file list or None): a directory is a DICOM series
    (`python_api.py:631-634`), a file NIfTI."""
    if isinstance(input, NiftiImage):
        return input, None
    path = Path(input)
    if path.is_dir():
        from boa_tpu_torch.io import dicom_io

        img, files, _first = dicom_io.read_series(path)
        return img, files
    return nifti.load(path), None


def _test_fake_predict(vol, spacing, task_id):
    """The `test != 0` stand-in segmentation: a centred ellipsoid of class 1
    over background (the reference substitutes committed example outputs,
    `nnunet.py:560-578`, which are not shipped)."""
    shape = vol.shape
    grids = np.ogrid[tuple(slice(0, n) for n in shape)]
    r2 = sum(((g - (n - 1) / 2.0) / max(n / 4.0, 1.0)) ** 2
             for g, n in zip(grids, shape))
    return (r2 <= 1.0).astype(np.uint8)


def _reorder_like_v1(seg: np.ndarray, map_v2: dict[int, str],
                     map_v1: dict[int, str]) -> np.ndarray:
    """Relabel a v2 `total` seg into v1 label ids by class name
    (`libs.py reorder_multilabel_like_v1`); v2-only classes are dropped."""
    inv_v1 = {v: k for k, v in map_v1.items()}
    lut = np.zeros(max(map_v2) + 1, seg.dtype)
    for lb, name in map_v2.items():
        lut[lb] = inv_v1.get(name, 0)
    return lut[seg]


def _rough_crop_mask(img, organs, *, robust, mr, body, store, quiet, device):
    """Rough low-res segmentation -> binary crop mask over `organs`
    (`python_api.py:673-736`): 6 mm total (3 mm when robust / MR) or the
    6 mm body model for trunc/extremities crops."""
    from boa_tpu_torch.inference.pipeline import predict_image

    if body:
        crop_task, fast = "body", True
    elif mr:
        crop_task, fast = "total_mr_fast", False
    elif robust:
        crop_task, fast = "total", True          # 3 mm
    else:
        crop_task, fast = "total_fastest", False  # 6 mm
    if not quiet:
        logger.info("Generating rough segmentation for cropping (%s)...", crop_task)
    rough = predict_image(img, crop_task, store, fast=fast, device=device)
    inv = {v: k for k, v in rough.label_map.items()}
    labels = [inv[o] for o in organs if o in inv]
    if body:
        mask = (np.asarray(rough.seg.data) > 0).astype(np.uint8)
    else:
        mask = np.isin(np.asarray(rough.seg.data), labels).astype(np.uint8)
    return NiftiImage(data=mask, affine=rough.seg.affine)


def _one_study(fn):
    """Each call of `fn` is one study: the recorder's root span `study`
    (`utils/timing.py`), which every span inside it shares."""

    @functools.wraps(fn)
    def call(*args, **kwargs):
        with timing.study():
            return fn(*args, **kwargs)
    return call


@_one_study
def totalsegmentator(
    input: "str | Path | NiftiImage",  # noqa: A002 (reference signature)
    output: "str | Path | None" = None,
    ml: bool = False,
    nr_thr_resamp: int = 1,   # accepted: the resample runs on the device
    nr_thr_saving: int = 6,
    fast: bool = False,
    nora_tag: str = "None",
    preview: bool = False,
    task: str = "total",
    roi_subset: list[str] | None = None,
    statistics: bool = False,
    radiomics: bool = False,
    crop_path: "str | Path | None" = None,
    body_seg: bool = False,
    force_split: bool = False,
    output_type: "str | list[str]" = "nifti",
    quiet: bool = False,
    verbose: bool = False,
    test: int = 0,
    skip_saving: bool = False,
    device: str = "gpu",
    license_number: str | None = None,
    statistics_exclude_masks_at_border: bool = True,
    no_derived_masks: bool = False,
    v1_order: bool = False,
    fastest: bool = False,
    roi_subset_robust: list[str] | None = None,
    stats_aggregation: str = "mean",
    remove_small_blobs: bool = False,
    statistics_normalized_intensities: bool = False,
    robust_crop: bool = False,
    higher_order_resampling: bool = False,
    save_probabilities: "str | Path | None" = None,
    # --- extensions (not in the reference signature) ---
    fake_predict=None,
    store: ModelStore | None = None,
    spans: dict | None = None,
):
    """Segment a CT/MR volume; returns the multilabel NiftiImage (and the
    statistics dict when `statistics`). Keyword-for-keyword and
    positionally compatible with the reference `totalsegmentator()`.

    `device` is "gpu" (the card; also "cuda", "gpu:N") or "cpu".
    `force_split` is a no-op (the pipeline needs no z triple-split);
    `nora_tag` is accepted but there is no nora node to call;
    `fake_predict` generalizes the reference's `test=N` hook (see
    `predict_image`). `spans`, when given, receives `predict_image`'s
    spans and `statistics` (original grid), `radiomics_histogram`,
    `radiomics_shape`, `save_nifti`, `save_dicom_seg`,
    `save_dicom_rtstruct` (of which `contours` is the tracer),
    `derived_masks`, `preview_fronts` and `preview_render`.
    """
    if roi_subset_robust is not None:
        roi_subset = roi_subset_robust
        robust_crop = True
    if roi_subset is not None and not isinstance(roi_subset, list):
        raise ValueError("roi_subset must be a list of strings")
    if roi_subset is not None and not task.startswith("total"):
        raise ValueError("roi_subset only works with task 'total' or 'total_mr'")
    if radiomics and output is None:
        raise ValueError("Output path is required for radiomics.")
    if radiomics and ml:
        raise ValueError("Radiomics not supported for multilabel "
                         "segmentation. Use without --ml option.")
    output_types = [output_type] if isinstance(output_type, str) else list(output_type)
    for ot in output_types:
        if ot not in ("nifti", "dicom_seg", "dicom_rtstruct"):
            raise ValueError(f"unsupported output_type {ot!r}")
    dev = named_device(device)
    is_mr = task.endswith("_mr")

    cfg = get_task(task, fast=fast) if not fastest else \
        get_task(f"{task}_fastest" if f"{task}_fastest" in TASKS else task)
    if cfg.license_required and not license_number:
        show_license_info()
    if force_split and not quiet:
        logger.info("force_split requested: not needed by this pipeline")

    from boa_tpu_torch.inference.pipeline import predict_image

    with timing.span("load_input"):
        img, dicom_files = _load_input(input)
    if np.asarray(img.data).ndim > 3:
        # trim the component axis once, so the original-grid statistics and
        # the preview see the volume predict_image segments
        img = NiftiImage(data=np.asarray(img.data)[..., 0], affine=img.affine.copy())
    if dicom_files is None and any(ot.startswith("dicom") for ot in output_types):
        raise ValueError("DICOM output is only supported for DICOM input "
                         "(a directory of instances)")
    store = store or ModelStore()
    if test != 0 and fake_predict is None:
        fake_predict = _test_fake_predict

    # --- crop mask: reuse from crop_path, or the rough-segmentation
    #     pre-pass for organ-cropped tasks / roi_subset / body_seg
    crop_mask = None
    crop_addon_mm = None
    crop_path = Path(crop_path) if crop_path is not None else None
    mask_file = crop_path / "crop_mask.nii.gz" if crop_path else None
    # crop_path is only a cache location: a mask there never crops a run
    # that would not have computed one itself (nnunet.py:419-426)
    wants_crop = bool(cfg.crop) or roi_subset is not None or (body_seg and not is_mr)
    if mask_file is not None and mask_file.exists() and wants_crop:
        crop_mask = nifti.load(mask_file)
        if roi_subset is not None and not cfg.crop:
            crop_addon_mm = (20, 20, 20)  # python_api.py:728 roi_subset addon
    elif fake_predict is None:
        if cfg.crop and cfg.crop_model != "total":
            # crop organs from another full task (teeth <- craniofacial_structures)
            rough = totalsegmentator(img, None, task=cfg.crop_model, quiet=quiet,
                                     store=store, ml=True, device=device)
            inv = {v: k for k, v in class_maps.get_class_map(cfg.crop_model).items()}
            labels = [inv[o] for o in cfg.crop if o in inv]
            mask = np.isin(np.asarray(rough.data), labels).astype(np.uint8)
            crop_mask = NiftiImage(data=mask, affine=rough.affine.copy())
        elif cfg.crop:
            body_crop = "body_trunc" in cfg.crop or "body_extremities" in cfg.crop
            crop_mask = _rough_crop_mask(img, cfg.crop, robust=robust_crop, mr=is_mr,
                                         body=body_crop, store=store, quiet=quiet,
                                         device=dev)
        elif roi_subset is not None:
            crop_mask = _rough_crop_mask(img, roi_subset, robust=robust_crop, mr=is_mr,
                                         body=False, store=store, quiet=quiet, device=dev)
            crop_addon_mm = (20, 20, 20)  # python_api.py:728 roi_subset addon
        elif body_seg and not is_mr:
            crop_mask = _rough_crop_mask(img, ("body",), robust=False, mr=False, body=True,
                                         store=store, quiet=quiet, device=dev)
        if crop_mask is not None and mask_file is not None:
            mask_file.parent.mkdir(parents=True, exist_ok=True)
            nifti.save(crop_mask, mask_file)

    # fast runs compute the statistics on the (coarse) model grid, in
    # predict_image (the reference's statistics_fast, `python_api.py:637-641`,
    # which checks `fast` only); other runs on the original grid at the end
    stats_on_model_grid = statistics and fast
    res = predict_image(
        img,
        f"{task}_fastest" if fastest and f"{task}_fastest" in TASKS else task, store,
        fast=fast, crop_mask=crop_mask, crop_addon_mm=crop_addon_mm,
        statistics=stats_on_model_grid, fake_predict=fake_predict,
        nnunet_resampling=higher_order_resampling,
        remove_small_blobs=remove_small_blobs,
        save_probabilities=save_probabilities,
        stats_aggregation=stats_aggregation,
        stats_normalized_intensities=statistics_normalized_intensities,
        stats_exclude_border=statistics_exclude_masks_at_border,
        device=dev, spans=spans)
    sp = Spans(spans, dev)

    seg_img = res.seg
    label_map = dict(res.label_map)
    stats = res.stats

    if v1_order and task == "total":
        map_v1 = class_maps.get_class_map("total_v1")
        data = _reorder_like_v1(np.asarray(seg_img.data), label_map, map_v1)
        seg_img = NiftiImage(data=data, affine=seg_img.affine.copy())
        label_map = dict(map_v1)
        seg_img.set_label_map(label_map)

    if roi_subset is not None:
        keep = {k for k, v in label_map.items() if v in roi_subset}
        data = np.asarray(seg_img.data)
        data = np.where(np.isin(data, list(keep)), data, 0).astype(data.dtype)
        seg_img = NiftiImage(data=data, affine=seg_img.affine.copy())
        seg_img.set_label_map(label_map)

    if nora_tag != "None" and nora_tag is not None:
        logger.info("nora_tag=%s accepted but no nora node is available", nora_tag)

    if statistics and not stats_on_model_grid:
        from boa_tpu_torch.measure.statistics import get_basic_statistics

        stats = get_basic_statistics(
            np.asarray(seg_img.data), np.asarray(img.data), img.zooms, label_map,
            exclude_masks_at_border=statistics_exclude_masks_at_border,
            metric=stats_aggregation, roi_subset=roi_subset,
            normalized_intensities=statistics_normalized_intensities, device=dev)
        sp.mark("statistics")

    if output is not None:
        output = Path(output)
        out_dir = output.parent if (ml or output_types[0].startswith("dicom")) else output
        if not skip_saving:
            _save_outputs(seg_img, label_map, output, output_types, ml, roi_subset,
                          dicom_files, task, nr_thr_saving=nr_thr_saving, spans=sp)
            if task == "body" and not ml and not no_derived_masks \
                    and "nifti" in output_types:
                _derived_body_masks(img, output, quiet)
                sp.mark("derived_masks")
        if statistics and stats is not None:
            out_dir.mkdir(parents=True, exist_ok=True)
            from boa_tpu_torch.utils.misc import np_json_default

            (out_dir / "statistics.json").write_text(
                json.dumps(stats, indent=2, default=np_json_default))
        if radiomics:
            from boa_tpu_torch.measure.radiomics import get_radiomics_features

            rad = get_radiomics_features(np.asarray(img.data), np.asarray(seg_img.data),
                                         img.zooms, label_map, device=dev, spans=spans)
            out_dir.mkdir(parents=True, exist_ok=True)
            (out_dir / "statistics_radiomics.json").write_text(json.dumps(rad, indent=2))
        if preview:
            from boa_tpu_torch.compute.preview import generate_preview

            out_dir.mkdir(parents=True, exist_ok=True)
            generate_preview(img, seg_img, label_map, out_dir / f"preview_{task}.png",
                             device=dev, spans=spans)

    if statistics:
        return seg_img, stats
    return seg_img


def _save_outputs(seg_img, label_map, output: Path, output_types, ml, roi_subset,
                  dicom_files, task, nr_thr_saving: int = 6,
                  spans: Spans | None = None) -> None:
    """Write the segmentation in every requested output type
    (`nnunet.py:728-803` single-/multi-output saving logic); the per-class
    masks on `nr_thr_saving` threads. `spans` times each in `save_<type>`."""
    sp = spans or Spans(None, "cpu")
    selected = dict(label_map)
    if roi_subset is not None:
        selected = {k: v for k, v in selected.items() if v in roi_subset}
    data = np.asarray(seg_img.data)

    multi = len(output_types) > 1
    base_dir = (output if output.suffix == "" else output.parent) if multi else None
    if multi:
        base_dir.mkdir(parents=True, exist_ok=True)
        base_name = f"{task}_segmentation" if output.suffix == "" \
            else output.stem.split(".")[0]

    headers = None
    for ot in output_types:
        with sp.span(f"save_{ot}"):
            if headers is None and ot.startswith("dicom"):
                from boa_tpu_torch.io import dicom

                headers = [dicom.dcmread(f, stop_before_pixels=True)
                           for f in dicom_files]
            if ot == "nifti":
                path = base_dir / f"{base_name}.nii.gz" if multi else output
                if ml:
                    path.parent.mkdir(parents=True, exist_ok=True)
                    nifti.save(seg_img, path)
                else:
                    out_dir = path if path.suffix == "" else path.parent
                    out_dir.mkdir(parents=True, exist_ok=True)
                    # masks of a Fortran-ordered copy are in the file's order:
                    # the writer deflates them with no layout pass
                    data_f = np.asfortranarray(data)

                    def save_mask(item):
                        lb, name = item
                        nifti.save(NiftiImage(data=(data_f == lb).astype(np.uint8),
                                              affine=seg_img.affine.copy()),
                                   out_dir / f"{name}.nii.gz")

                    with ThreadPoolExecutor(max(1, int(nr_thr_saving))) as pool:
                        list(pool.map(save_mask, selected.items()))
            elif ot == "dicom_seg":
                from boa_tpu_torch.io import dicom, dicom_seg

                path = base_dir / f"{base_name}_seg.dcm" if multi else output
                ds = dicom_seg.write_multiclass_seg(
                    data, selected, headers, series_description=f"TotalSegmentator {task}")
                path.parent.mkdir(parents=True, exist_ok=True)
                dicom.dcmwrite(path, ds)
            elif ot == "dicom_rtstruct":
                from boa_tpu_torch.io import dicom, rtstruct

                path = base_dir / f"{base_name}_rtstruct.dcm" if multi else output
                ds = rtstruct.write_rtstruct(data, selected, headers, spans=sp.out)
                path.parent.mkdir(parents=True, exist_ok=True)
                dicom.dcmwrite(path, ds)


def _derived_body_masks(img, out_dir: Path, quiet: bool) -> None:
    """body task, per-class mode: the combined body.nii.gz and skin.nii.gz
    (`nnunet.py:821-827`)."""
    from boa_tpu_torch.ops.postprocessing import extract_skin
    from boa_tpu_torch.tools.combine_masks import combine_masks

    if not quiet:
        logger.info("Creating body.nii.gz and skin.nii.gz")
    body_img = combine_masks(out_dir, "body")
    nifti.save(body_img, out_dir / "body.nii.gz")
    skin = extract_skin(np.asarray(img.data), np.asarray(body_img.data) > 0)
    nifti.save(NiftiImage(data=skin.astype(np.uint8), affine=body_img.affine.copy()),
               out_dir / "skin.nii.gz")
