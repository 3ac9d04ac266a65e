"""BCA end to end: body parts, body regions, tissues and the report.

Counterpart of `boa_tpu/bca/pipeline.py` (body_composition_analysis
`commands.py` `run_pipeline` and `infer/infer.py`): `body_parts` (task 543)
and `body_regions` (task 542), each a 5-fold ensemble (fold 0 with
`fast_bca`), skipped where their file exists unless `recompute`, each
followed by its host postprocess; the tissue subclassification on the
device; the examined body part; the per-vertebra slice windows from `total`;
the report builder; `body_parts.nii.gz`, `body_regions.nii.gz`,
`tissues.nii.gz`, `vertebrae.json`, `bca-measurements.json` and, with
`save_pdf` (the default), `report.pdf`.
"""

from __future__ import annotations

import json
import logging
from concurrent.futures import Future
from pathlib import Path
from time import perf_counter
from typing import Any, Callable

import numpy as np

from boa_tpu_torch.bca import postprocess as bca_pp
from boa_tpu_torch.bca.definitions import BodyRegion
from boa_tpu_torch.bca.report import AggregatableBodyPart, Builder, create_vertebrae_info
from boa_tpu_torch.bca.tissues import subclassify_tissues
from boa_tpu_torch.device import resolve_device
from boa_tpu_torch.inference.pipeline import predict_image
from boa_tpu_torch.io import nifti
from boa_tpu_torch.tasks import class_maps
from boa_tpu_torch.tasks.registry import get_task
from boa_tpu_torch.utils.timing import Spans
from boa_tpu_torch.weights.store import ModelStore

logger = logging.getLogger(__name__)

_POSTPROCESS = {"body_parts": bca_pp.postprocess_part_segmentation,
                "body_regions": bca_pp.postprocess_region_segmentation}


def _postprocess(task_name: str, res, spans: dict | None) -> nifti.NiftiImage:
    """The task's host postprocess of its labels, as a label image; its
    seconds go to `postprocess_{task_name}`. Runs no device work, so it may
    run on the HostWorker."""
    t0 = perf_counter()
    seg = _POSTPROCESS[task_name](np.asarray(res.seg.data, dtype=np.uint8))
    out = nifti.NiftiImage(data=seg, affine=res.seg.affine, crop_info=res.seg.crop_info)
    out.set_label_map(res.label_map)
    if spans is not None:   # a key only this stage writes
        spans[f"postprocess_{task_name}"] = perf_counter() - t0
    return out


def _finish(task_name: str, res, output_file: Path, spans: dict | None) -> nifti.NiftiImage:
    out = _postprocess(task_name, res, spans)
    nifti.save(out, output_file)
    return out


def _load_cached(output_file: Path, ct_img: nifti.NiftiImage) -> nifti.NiftiImage:
    """A label file from an earlier run, cut to the CT's body crop (the
    file is on the full grid)."""
    img = nifti.load(output_file)
    ci = getattr(ct_img, "crop_info", None)
    if ci is None or img.shape[:2] == ct_img.shape[:2]:
        return img
    return nifti.NiftiImage(data=np.ascontiguousarray(img.data[ci.x0:ci.x1, ci.y0:ci.y1]),
                            affine=ct_img.affine.copy(), extensions=list(img.extensions),
                            crop_info=ci)


def bca_inference(
    ct_img: nifti.NiftiImage,
    output_dir: Path,
    task_name: str,
    store,
    fast_bca: bool = False,
    recompute: bool = False,
    compute_dtype: str = "bfloat16",
    fake_predict: Callable | None = None,
    worker=None,
    inline_postprocess: bool = False,
    device=None,
    spans: dict | None = None,
):
    """One BCA model with its postprocess, written to `{task_name}.nii.gz`;
    the file from an earlier run is loaded instead unless `recompute`.

    Returns the label image or, with a `worker`, a Future of it (postprocess
    and save on the worker). `inline_postprocess=True` keeps the postprocess
    on this thread and hands only the save to the worker, returning the
    image: for labels the next stage needs at once. `device` defaults to the
    card. `spans`, when given, receives `predict_{task id}` (the model's
    sliding window), `predict_image`'s other stages summed over models
    (`tiles`, `tile_forwards`, ...), `postprocess_{task_name}` and `save`."""
    device = resolve_device(device)
    output_file = Path(output_dir) / f"{task_name}.nii.gz"
    if not recompute and output_file.is_file():
        logger.info("Loading already computed %s", task_name)
        img = _load_cached(output_file, ct_img)
        if worker is None or inline_postprocess:
            return img
        fut: Future = Future()
        fut.set_result(img)
        return fut
    sub: dict | None = None if spans is None else {}
    res = predict_image(ct_img, task_name, store, fast=fast_bca, compute_dtype=compute_dtype,
                        fake_predict=fake_predict, device=device, spans=sub)
    if spans is not None:
        tid = get_task(task_name).task_ids[0]
        for k, v in sub.items():
            k = f"predict_{tid}" if k == "predict" else k
            spans[k] = spans.get(k, 0) + v
    if worker is not None and not inline_postprocess:
        return worker.submit(f"bca-{task_name}-finish", _finish, task_name, res,
                             output_file, spans)
    out = _postprocess(task_name, res, spans)
    sp = Spans(spans, device)
    if worker is not None:
        worker.submit(f"save-{task_name}.nii.gz", nifti.save, out, output_file)
    else:
        nifti.save(out, output_file)
    sp.mark("save")
    return out


def run_pipeline(
    input_image: Path | nifti.NiftiImage,
    output_dir: Path,
    store=None,
    fast_bca: bool = False,
    examined_body_region: str | None = None,
    median_filtering: bool = False,
    save_pdf: bool = True,
    recompute: bool = True,
    theme: str = "light",
    compute_dtype: str = "bfloat16",
    fake_predict: Callable | None = None,
    total_seg: np.ndarray | None = None,
    worker=None,
    stats_out: dict[str, Any] | None = None,
    images_out: dict[str, Any] | None = None,
    device=None,
    spans: dict | None = None,
) -> dict[str, Any]:
    """The bca-measurements dict, also written to `bca-measurements.json`.

    `examined_body_region` ("abdomen", "thorax" or "neck") replaces the
    detection from the regions; `total_seg` (`total`'s labels on the CT's
    grid) replaces the reload of `total.nii.gz` for the vertebra windows;
    `stats_out` receives `bca_regions` (bits: 1 abdominal cavity, 2 thoracic
    cavity, 4 brain); `images_out` the three label images. With a `worker`
    (utils/stages.HostWorker) the body_parts postprocess runs behind the
    body_regions prediction and the saves behind the report; every file is
    written when this returns; the PDF renders there too, from `prepare`'s
    output alone. `store` defaults to `ModelStore()`
    (`$BOA_WEIGHTS_PATH`), `device` to the card. `spans`, when
    given, receives the seconds of `bca_inference`'s stages and of
    `tissues` (`tissues.*` its parts), `load_total`, `body_parts_wait`,
    `builder` (`builder.*`), `vertebrae`, `prepare`, `report_pdf` (the
    render and its write), `save` and `save_wait`."""
    device = resolve_device(device)
    store = store or ModelStore()
    output_dir = Path(output_dir)
    output_dir.mkdir(exist_ok=True, parents=True)
    ct_img = (input_image if isinstance(input_image, nifti.NiftiImage)
              else nifti.load(input_image))
    kw = dict(fast_bca=fast_bca, recompute=recompute, compute_dtype=compute_dtype,
              fake_predict=fake_predict, worker=worker, device=device, spans=spans)
    # body_parts' postprocess hides behind the body_regions prediction; the
    # regions feed the tissue pass at once, so theirs stays on this thread
    body_parts_res = bca_inference(ct_img, output_dir, "body_parts", store, **kw)
    body_regions_img = bca_inference(ct_img, output_dir, "body_regions", store,
                                     inline_postprocess=True, **kw)

    sp = Spans(spans, device)
    save_futures: list = []
    regions = np.asarray(body_regions_img.data)
    ct_dev = ct_img.device_data(device)
    tissues, tissues_dev, regions_dev = subclassify_tissues(
        ct_dev, regions, median_filtering=median_filtering, device=device, spans=spans)
    sp.mark("tissues")
    tis_img = nifti.NiftiImage(data=tissues, affine=body_regions_img.affine,
                               crop_info=body_regions_img.crop_info)
    tis_img.set_label_map({int(k): v for v, k in class_maps.bca_tissues().items()})
    if worker is not None:
        save_futures.append(worker.submit("save-tissues.nii.gz", nifti.save, tis_img,
                                          output_dir / "tissues.nii.gz"))
    else:
        nifti.save(tis_img, output_dir / "tissues.nii.gz")
    sp.mark("save")

    # `total`'s labels: from the caller, else from an earlier run's file (on
    # the full grid, cut to this run's body crop)
    total_path = output_dir / "total.nii.gz"
    if total_seg is None and total_path.exists():
        total_seg = np.asarray(_load_cached(total_path, ct_img).data)
    tm_path = output_dir / "total-measurements.json"
    total_measurements = json.loads(tm_path.read_text()) if tm_path.exists() else None
    sp.mark("load_total")
    body_parts_img = (body_parts_res.result() if isinstance(body_parts_res, Future)
                      else body_parts_res)
    sp.mark("body_parts_wait")

    spacing = ct_img.zooms
    builder = Builder(ct_dev, np.asarray(body_parts_img.data), regions, tissues, spacing,
                      theme, tissues_dev=tissues_dev, regions_dev=regions_dev,
                      device=device, spans=spans)
    if examined_body_region:
        body_part = AggregatableBodyPart[examined_body_region.upper()]
    else:
        body_part = AggregatableBodyPart.from_body_regions(
            regions, spacing[2], z_counts=builder.region_z_counts())
        if body_part == AggregatableBodyPart.NONE:
            logger.warning("No supported body part detected")
    builder.examined_body_part = body_part
    if stats_out is not None:
        zc = builder.region_z_counts()
        flag = 0
        for bit, region in ((1, BodyRegion.ABDOMINAL_CAVITY),
                            (2, BodyRegion.THORACIC_CAVITY), (4, BodyRegion.BRAIN)):
            r = int(region)
            if r < zc.shape[1] and zc[:, r].sum() > 0:
                flag |= bit
        stats_out["bca_regions"] = flag
    sp.mark("builder")

    vertebrae_info = None
    if total_seg is not None:
        vertebrae_info = create_vertebrae_info(total_seg, body_part,
                                               class_maps.get_class_map("total"))
    sp.mark("vertebrae")
    prepared = builder.prepare(vertebrae_info, total=total_seg,
                               total_measurements=total_measurements)
    sp.mark("prepare")
    if save_pdf:
        if worker is not None:
            save_futures.append(worker.submit("bca-report-pdf", _write_pdf, builder, prepared,
                                              output_dir / "report.pdf", spans))
        else:
            _write_pdf(builder, prepared, output_dir / "report.pdf", spans)
        sp.restart()
    json_data = builder.create_json(**prepared)
    if vertebrae_info:
        (output_dir / "vertebrae.json").write_text(json.dumps(vertebrae_info, indent=2))
    (output_dir / "bca-measurements.json").write_text(json.dumps(json_data, indent=2))
    sp.mark("save")
    for fut in save_futures:
        fut.result()
    sp.mark("save_wait")
    if images_out is not None:
        images_out["body_parts"] = body_parts_img
        images_out["body_regions"] = body_regions_img
        images_out["tissues"] = tis_img
    return json_data


def _write_pdf(builder: Builder, prepared: dict[str, Any], path: Path,
               spans: dict | None) -> None:
    t0 = perf_counter()
    path.write_bytes(builder.create_pdf(**prepared))
    if spans is not None:   # a key only this stage writes
        spans["report_pdf"] = spans.get("report_pdf", 0) + perf_counter() - t0
