"""TotalSegmentator measurements -> workbook rows.

Counterpart of `boa_tpu/compute/ts_metrics.py` (body_organ_analysis
`compute/ts_metrics.py:32-171`): reads `total-measurements.json`, measures
the body's major and minor axes on the middle L3 slice, and gives the info
rows and the regions-statistics and cnr-adjusted tables of the workbook,
as (columns, rows) tables in place of pandas frames. `store_axes=True`
draws the axes over the slice into `major_minor_axis.png` with the port's
own rasterizer (`render/`).
"""

from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Any

import numpy as np

from boa_tpu_torch.compute.geometry import find_axes
from boa_tpu_torch.io import nifti
from boa_tpu_torch.io.xlsx import Table, records_table
from boa_tpu_torch.ops.cropping import pad_back
from boa_tpu_torch.render import raster
from boa_tpu_torch.tasks import class_maps
from boa_tpu_torch.utils.misc import (ADDITIONAL_MODELS_OUTPUT_NAME, convert_name,
                                      create_mask)

logger = logging.getLogger(__name__)

#: regions whose CNR feeds the info sheet, with their row labels
_CNR_INFO_ROWS = (
    ("aorta", "CNRAorta"),
    ("inferior_vena_cava", "CNRVCI"),
    ("portal_vein_and_splenic_vein", "CNRPortalSplenicVein"),
)

#: cnr-adjusted sheet row order (reference sheet layout)
_CNR_ADJUSTED_ROWS = ("aorta", "pulmonary_artery", "autochthon",
                      "autochthon_left", "autochthon_right")

# the reference's plot: `imshow` of the slice in the axes of a default
# 6.4 x 4.8 in figure at 200 dpi (about 740 pixels on the longer side),
# lines 2.5 pt wide
_PLOT_PX = 740
_LINE_PX = 2.5 * 200 / 72


def _plot_axes_png(middle_slice: np.ndarray, major, minor, path: Path) -> None:
    """The slice in gray (rows down, as `imshow` shows it) scaled to about
    740 pixels, the major axis in green and the minor in blue."""
    rows, cols = middle_slice.shape
    scale = _PLOT_PX / max(rows, cols)
    canvas = raster.Canvas(max(1, round(cols * scale)), max(1, round(rows * scale)))
    canvas.blit(raster.gray(middle_slice), (0, 0, canvas.width, canvas.height))
    sx, sy = canvas.width / cols, canvas.height / rows
    for (a, b), color in ((major, (0.0, 0.5, 0.0)), (minor, (0.0, 0.0, 1.0))):
        # plot coordinates (a[0], a[1]) are (column, row); pixel centres
        # sit at whole data coordinates
        canvas.line(((a[0] + 0.5) * sx, (a[1] + 0.5) * sy),
                    ((b[0] + 0.5) * sx, (b[1] + 0.5) * sy), color, _LINE_PX)
    canvas.save_png(path)


def major_minor_axis(l3_mask: np.ndarray, body_mask: np.ndarray, img_spacing,
                     plot_axes: Path | None = None
                     ) -> tuple[float | None, float | None]:
    """Axes of the middle L3 axial slice, in mm; masks in (x, y, z) order.
    With `plot_axes` (a folder), also `major_minor_axis.png` there."""
    if np.sum(l3_mask) == 0 or np.sum(body_mask) == 0:
        return None, None
    slices = np.where(l3_mask.any(axis=(0, 1)))[0]
    middle_slice = body_mask[:, :, int(np.median(slices))]
    if np.sum(middle_slice) == 0:
        return None, None
    endpoints = find_axes(middle_slice)
    if any(p is None for p in endpoints):
        return None, None
    major_a, major_b, minor_a, minor_b = endpoints
    if plot_axes is not None:
        _plot_axes_png(middle_slice, (major_a, major_b), (minor_a, minor_b),
                      Path(plot_axes) / "major_minor_axis.png")
    avg_spacing = float(np.mean(img_spacing))
    return (float(np.hypot(*(major_a - major_b))) * avg_spacing,
            float(np.hypot(*(minor_a - minor_b))) * avg_spacing)


def get_cnr_for_region(measurements: dict[str, Any], region: str) -> Any:
    """CNR of a total-model region, or None when the region is absent."""
    entry = measurements["segmentations"]["total"].get(region, {})
    if not entry.get("present"):
        return None
    return entry["cnr"]


def _excel_key(key: str) -> str:
    new_key = convert_name(key)
    if "Hu" in new_key:
        new_key = new_key.replace("Hu", "HU")
    elif new_key == "Cnr":
        new_key = "CNR"
    return new_key


def _stat_record(prefix: dict[str, Any], stats: dict[str, Any]) -> dict[str, Any]:
    rec = dict(prefix)
    for key, val in stats.items():
        rec[_excel_key(key)] = val
    return rec


def _body_axes_cm(ct_path: Path, segmentation_folder: Path, store_axes: bool,
                  seg_images: dict[str, Any] | None = None
                  ) -> tuple[float | None, float | None]:
    """L3-level body axes in cm, or (None, None) when inputs are missing.

    `seg_images` (name -> NiftiImage, `compute_all_models(images_out=...)`)
    saves reloading the label files; the CT gives only its spacing (a
    header read)."""
    seg_images = seg_images or {}

    def _seg(name: str):
        img = seg_images.get(name)
        if img is not None:
            return np.asarray(img.data), getattr(img, "crop_info", None)
        path = segmentation_folder / f"{name}.nii.gz"
        if not path.exists():
            return None, None
        return np.asarray(nifti.load(path).data), None

    region_data, region_ci = _seg("total")
    body_data, body_ci = _seg("body_parts")
    if region_data is None or body_data is None:
        return None, None
    if region_data.shape != body_data.shape:
        # one seg is on the body-cropped grid, the other on the full grid:
        # pad the cropped one back
        if region_ci is not None:
            region_data = pad_back(region_data, region_ci)
        if body_ci is not None:
            body_data = pad_back(body_data, body_ci)
    l3_label = {v: k for k, v in class_maps.get_class_map("total").items()}["vertebrae_L3"]
    _, ct_affine = nifti.load_header(Path(ct_path))
    spacing_xy = np.asarray([np.linalg.norm(ct_affine[:3, i]) for i in range(2)])
    major_mm, minor_mm = major_minor_axis(
        l3_mask=create_mask(region_data, l3_label),
        body_mask=create_mask(body_data, 1),
        img_spacing=spacing_xy,
        plot_axes=segmentation_folder if store_axes else None,
    )
    if major_mm is None or minor_mm is None:
        return None, None
    return major_mm / 10.0, minor_mm / 10.0


def _region_sort_key(rec: dict[str, Any]):
    # pandas' sort_values(["ModelName", "BodyRegion"]): stable, NaN last
    region = rec.get("BodyRegion")
    return rec["ModelName"], region is None, region or ""


def compute_segmentator_metrics(
    ct_path: Path,
    segmentation_folder: Path,
    store_axes: bool = False,
    seg_images: dict[str, Any] | None = None,
) -> tuple[list[dict[str, Any]], Table, Table]:
    """(info rows, regions-statistics table, cnr-adjusted table)."""
    segmentation_folder = Path(segmentation_folder)
    with (segmentation_folder / "total-measurements.json").open() as of:
        measurements = json.load(of)

    major_axis, minor_axis = _body_axes_cm(ct_path, segmentation_folder, store_axes,
                                           seg_images=seg_images)
    mean_axis = None
    if major_axis is not None and minor_axis is not None:
        mean_axis = (major_axis + minor_axis) / 2

    records: list[dict[str, Any]] = []
    for model_name, regions in measurements["segmentations"].items():
        for region, stats in regions.items():
            records.append(_stat_record(
                {"ModelName": convert_name(model_name),
                 "BodyRegion": convert_name(region)}, stats))
    for model_name, filename in ADDITIONAL_MODELS_OUTPUT_NAME.items():
        if not (segmentation_folder / f"{filename}.nii.gz").exists():
            records.append({"ModelName": convert_name(model_name), "Present": False})
    columns, _ = records_table(records)
    records.sort(key=_region_sort_key)

    cnr_adjusted = measurements.get("cnr_adjusted") or {}
    cnr_records = [
        _stat_record({"BodyRegion": convert_name(region)}, cnr_adjusted[region])
        for region in _CNR_ADJUSTED_ROWS if region in cnr_adjusted
    ]

    info_values = [("Noise", measurements["info"]["autochthon_std"])]
    info_values += [(label, get_cnr_for_region(measurements, region))
                    for region, label in _CNR_INFO_ROWS]
    info_values += [("MaxAxisL3_cm", major_axis),
                    ("MinAxisL3_cm", minor_axis),
                    ("MeanAxisL3_cm", mean_axis)]
    additional_info = [{"name": name, "value": value}
                       for name, value in info_values if value is not None]
    return (additional_info,
            (columns, [[rec.get(c) for c in columns] for rec in records]),
            records_table(cnr_records))
