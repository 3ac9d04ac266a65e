"""Per-region HU measurement engine.

Counterpart of `boa_tpu/measure/measurements.py` (body_organ_analysis
`compute/measurements.py`): per region the volume (ml), mean/std/min/
median/max HU and the 25th/75th percentiles, the CNR against an eroded,
fat-free autochthon reference (box erosion 6^3), CNR-adjusted variants of
{aorta, autochthon_*, pulmonary_artery}, and the pulmonary fat (ct_pfav)
metrics per lung lobe.

One pass builds the per-class integer-HU histograms on the device
(`statistics.segmented_stats`); every plain-region statistic, and every
statistic restricted to an HU range (the pulmonary fat is exactly
`class ∩ HU ∈ [-200, -40]`, a slice of the histogram), follows exactly on
the host in float64. The eroded masks need two more device passes: the
autochthon reference and, for all CNR-adjusted regions at once, a label
volume eroded by two windowed extrema. Masked moments are summed in int64
and so are exact.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Any

import numpy as np
import torch

from boa_tpu_torch.device import resolve_device
from boa_tpu_torch.measure.statistics import HU_MIN, N_BINS, segmented_stats
from boa_tpu_torch.ops.morphology import box_max, erosion_box_border1
from boa_tpu_torch.tasks import class_maps
from boa_tpu_torch.utils.misc import ADDITIONAL_MODELS_OUTPUT_NAME, create_mask
from boa_tpu_torch.utils.timing import Spans

logger = logging.getLogger(__name__)

ADIPOSE_TISSUE = (-200, -40)
CNR_ADJUSTED_REGIONS: dict[str, set[str]] = {
    "total": {"aorta", "autochthon_left", "autochthon_right"},
    "heartchambers_highres": {"pulmonary_artery"},
}

LUNG_MASKS = [
    "lung_upper_lobe_left",
    "lung_lower_lobe_left",
    "lung_upper_lobe_right",
    "lung_middle_lobe_right",
    "lung_lower_lobe_right",
]

_HU_VALUES = np.arange(HU_MIN, HU_MIN + N_BINS, dtype=np.float64)


def _class_map_for_model(model_name: str) -> dict[str, int]:
    return {name: idx for idx, name in class_maps.get_class_map(model_name).items()}


def _metrics_from_hist(hist: np.ndarray, ml_per_voxel: float) -> dict[str, Any]:
    """Exact region metrics from an integer-HU histogram (float64 host math)."""
    hist = np.asarray(hist, np.float64)
    n = float(hist.sum())
    if n == 0:
        return {"present": False}
    m: dict[str, Any] = {"present": True}
    m["volume_ml"] = float(n * ml_per_voxel)
    s1 = float((hist * _HU_VALUES).sum())
    s2 = float((hist * _HU_VALUES ** 2).sum())
    mean = s1 / n
    m["mean_hu"] = mean
    m["std_hu"] = float(np.sqrt(max(s2 / n - mean * mean, 0.0)))
    nz = np.nonzero(hist)[0]
    m["min_hu"] = float(_HU_VALUES[nz[0]])
    m["max_hu"] = float(_HU_VALUES[nz[-1]])
    cum = np.cumsum(hist)
    for label, q in [("median_hu", 0.5), ("25th_percentile_hu", 0.25),
                     ("75th_percentile_hu", 0.75)]:
        pos = q * (n - 1)
        lo_idx = int(np.floor(pos))
        hi_idx = min(lo_idx + 1, int(n) - 1)
        frac = pos - lo_idx
        lo_v = _HU_VALUES[np.searchsorted(cum, lo_idx + 1)]
        hi_v = _HU_VALUES[np.searchsorted(cum, hi_idx + 1)]
        m[label] = float(lo_v + (hi_v - lo_v) * frac)
    return m


def _add_cnr(m: dict[str, Any], autochthon_mean, autochthon_std) -> None:
    if not m.get("present"):
        return
    if autochthon_mean is not None and autochthon_std is not None:
        m["cnr"] = (m["mean_hu"] - autochthon_mean) / autochthon_std
    else:
        m["cnr"] = None


def _fat_slice() -> slice:
    return slice(ADIPOSE_TISSUE[0] - HU_MIN, ADIPOSE_TISSUE[1] - HU_MIN + 1)


def _nonfat(ct: torch.Tensor) -> torch.Tensor:
    return (ct < ADIPOSE_TISSUE[0]) | (ct > ADIPOSE_TISSUE[1])


def masked_stats(ct: torch.Tensor, mask: torch.Tensor) -> tuple[float, float, int]:
    """mean/std/count of an integer CT under a boolean mask, summed in int64."""
    vals = ct[mask].to(torch.int64)
    n = int(vals.numel())
    if n == 0:
        return 0.0, 0.0, 0
    s1, s2 = int(vals.sum()), int((vals * vals).sum())
    mean = s1 / n
    return mean, float(np.sqrt(max(s2 / n - mean * mean, 0.0))), n


def autochthon_reference(ct_dev: torch.Tensor, autochthon_mask: torch.Tensor
                         ) -> tuple[float | None, float | None]:
    """Mean/std HU of the eroded, fat-excluded autochthon."""
    fat_free = autochthon_mask & _nonfat(ct_dev)
    eroded = erosion_box_border1(fat_free, 6) > 0
    mean, std, n = masked_stats(ct_dev, eroded)
    if n == 0:
        return None, None
    return mean, std


def _adjusted_label_volume(seg: torch.Tensor, ct: torch.Tensor, labels: tuple[int, ...],
                           fat_excl: tuple[bool, ...], size: int = 6) -> torch.Tensor:
    """Disjoint CNR-adjusted region labels (1..n), each box-eroded, in one
    pass: the regions are distinct classes of one label map, so a voxel
    keeps its label i > 0 iff every in-volume voxel of its size^3 window
    has label i (skimage's border=True erosion of each mask), which is the
    window's min equal to its max. The ±1e9 padding leaves both extrema to
    the voxels inside; float32 holds it and the labels exactly. int32."""
    k = torch.zeros(seg.shape, dtype=torch.int32, device=seg.device)
    nonfat = _nonfat(ct)
    for i, (lb, fx) in enumerate(zip(labels, fat_excl), start=1):
        m = seg == lb
        if fx:
            m &= nonfat
        k.masked_fill_(m, i)
    kf = k.to(torch.float32)
    lo = size // 2
    hi = size - 1 - lo
    kmin = -box_max(-kf, size, lo, hi, -1e9)
    kmax = box_max(kf, size, lo, hi, -1e9)
    return torch.where((kmin == kmax) & (k > 0), k, 0)


def _cnr_adjusted_metrics(ct_dev, seg_dev, regions: dict[str, int], ml_per_voxel,
                          autochthon_mean, autochthon_std) -> dict[str, Any]:
    """CNR-adjusted metrics of all of a model's regions: fat exclusion for
    the autochthon, the 6^3 erosion and exact device histograms, so the
    percentiles match np.percentile on the masked voxels."""
    names = sorted(regions)
    labels = tuple(regions[n] for n in names)
    fat_excl = tuple("autochthon" in n for n in names)
    eroded = _adjusted_label_volume(seg_dev, ct_dev, labels, fat_excl)
    hists = segmented_stats(eroded, ct_dev, len(names) + 1)["hist"].cpu().numpy()
    out: dict[str, Any] = {}
    for i, name in enumerate(names, start=1):
        m = _metrics_from_hist(hists[i], ml_per_voxel)
        if m.get("present"):
            if name.partition("_")[0] == "autochthon":
                m["cnr"] = None
            else:
                _add_cnr(m, autochthon_mean, autochthon_std)
        out[name] = m
    return out


def compute_measurements_arrays(
    ct_data: np.ndarray,
    segmentations: dict[str, np.ndarray],
    spacing: tuple[float, float, float],
    cnr_adjustment: bool = False,
    ct_dev: torch.Tensor | None = None,
    seg_devs: dict[str, torch.Tensor] | None = None,
    device=None,
    spans: dict | None = None,
) -> dict[str, Any]:
    """Array-level measurement engine.

    ct_data: (X, Y, Z) HU volume; segmentations: {model_name: label volume
    on the same grid}; spacing in mm. `ct_dev` and `seg_devs` supply copies
    already on the device (an int16 `ct_dev` only: another CT is cast on
    the host with numpy's semantics and uploaded). `device` (default the
    card) is used where nothing is supplied. `spans`, when given, receives
    the seconds of `{model}.upload`, `{model}.histogram`, `autochthon` and
    `{model}.cnr_adjusted`."""
    if ct_dev is not None and ct_dev.dtype == torch.int16:
        dev = ct_dev.device
    else:
        dev = resolve_device(device) if ct_dev is None else ct_dev.device
        ct_dev = torch.from_numpy(np.asarray(ct_data, dtype=np.int16)).to(dev)
    sp = Spans(spans, dev)
    measurements: dict[str, Any] = {"segmentations": {}, "info": {}}
    ml_per_voxel = float(np.prod(spacing)) / 1000.0

    autochthon_mean = autochthon_std = None
    ordered = sorted(segmentations.keys(), key=lambda m: m != "total")
    for model_name in ordered:
        seg = segmentations[model_name]
        if seg.shape != ct_data.shape:
            raise ValueError("segmentation and CT grids differ")
        label_map = _class_map_for_model(model_name)
        num_classes = max(label_map.values()) + 1
        seg_dev = (seg_devs or {}).get(model_name)
        if seg_dev is None:
            seg_dev = torch.from_numpy(np.ascontiguousarray(seg)).to(dev)
        sp.mark(f"{model_name}.upload")
        hists = segmented_stats(seg_dev, ct_dev, num_classes)["hist"].cpu().numpy()
        sp.mark(f"{model_name}.histogram")

        if model_name == "total":
            auto_mask = ((seg_dev == label_map["autochthon_left"])
                         | (seg_dev == label_map["autochthon_right"]))
            autochthon_mean, autochthon_std = autochthon_reference(ct_dev, auto_mask)
            sp.mark("autochthon")

        model_metrics: dict[str, Any] = {}
        for region, label in label_map.items():
            m = _metrics_from_hist(hists[label], ml_per_voxel)
            _add_cnr(m, autochthon_mean, autochthon_std)
            model_metrics[region] = m
        if "autochthon_left" in label_map and "autochthon_right" in label_map:
            h = hists[label_map["autochthon_left"]] + hists[label_map["autochthon_right"]]
            m = _metrics_from_hist(h, ml_per_voxel)
            _add_cnr(m, autochthon_mean, autochthon_std)
            model_metrics["autochthon"] = m

        if model_name == "total":
            # pulmonary fat: class ∩ HU ∈ [-200, -40] is a histogram slice
            fat = _fat_slice()

            def fat_metrics(labels: list[int]) -> dict[str, Any]:
                h = np.zeros(N_BINS)
                for lb in labels:
                    h[fat] += hists[lb][fat]
                m = _metrics_from_hist(h, ml_per_voxel)
                _add_cnr(m, autochthon_mean, autochthon_std)
                return m

            for region_name in LUNG_MASKS:
                model_metrics["ct_pfav_" + region_name] = fat_metrics(
                    [label_map[region_name]])
            for side in ["left", "right"]:
                parts = [label_map[n] for n in LUNG_MASKS if n.endswith(side)]
                model_metrics[f"ct_pfav_lobe_{side}"] = fat_metrics(parts)
            model_metrics["ct_pfav_lungs"] = fat_metrics(
                [label_map[n] for n in LUNG_MASKS])

        measurements["segmentations"][model_name] = model_metrics

        if cnr_adjustment and model_name in CNR_ADJUSTED_REGIONS:
            if autochthon_mean is None or autochthon_std is None:
                logger.warning(
                    "Skipping CNR-adjusted measurements for %s: autochthon "
                    "reference unavailable.", model_name)
            else:
                regions = {r: label_map[r] for r in CNR_ADJUSTED_REGIONS[model_name]
                           if r in label_map}
                if regions:
                    measurements.setdefault("cnr_adjusted", {}).update(
                        _cnr_adjusted_metrics(ct_dev, seg_dev, regions, ml_per_voxel,
                                              autochthon_mean, autochthon_std))
                    sp.mark(f"{model_name}.cnr_adjusted")

    measurements["info"]["autochthon_mean"] = autochthon_mean
    measurements["info"]["autochthon_std"] = autochthon_std
    return measurements


def compute_pfav_mask(ct_data: np.ndarray, total_seg: np.ndarray) -> np.ndarray:
    """The ct_pfav.nii.gz mask on the host: all-lung fat voxels."""
    label_map = _class_map_for_model("total")
    lungs = create_mask(total_seg, [label_map[n] for n in LUNG_MASKS])
    fat = (ct_data >= ADIPOSE_TISSUE[0]) & (ct_data <= ADIPOSE_TISSUE[1])
    return (lungs & fat).astype(np.uint8)


def _pfav_mask_device(ct_dev: torch.Tensor, seg_dev: torch.Tensor) -> np.ndarray:
    """The pfav mask from the CT and labels already on the device."""
    from boa_tpu_torch.ops.packing import download_mask

    label_map = _class_map_for_model("total")
    lut = torch.zeros(max(label_map.values()) + 1, dtype=torch.bool, device=seg_dev.device)
    lut[[label_map[name] for name in LUNG_MASKS]] = True
    lungs = lut[seg_dev.long()]
    fat = (ct_dev >= ADIPOSE_TISSUE[0]) & (ct_dev <= ADIPOSE_TISSUE[1])
    return download_mask(lungs & fat)


def compute_measurements(
    ct_path: Path,
    segmentation_folder: Path,
    models: list[str],
    cnr_adjustment: bool,
    ct_image=None,
    seg_images: dict[str, Any] | None = None,
    worker=None,
    device=None,
    spans: dict | None = None,
    save_futures: list | None = None,
) -> dict[str, Any]:
    """File-level wrapper: reads the CT and each model's segmentation from
    `segmentation_folder` (or takes the images in `seg_images`, with their
    cached device copies), measures on `device` (default the card) and
    writes ct_pfav.nii.gz when `total` is present. With `worker` the save
    runs there and its Future is appended to `save_futures`, for the caller
    to wait on; without a list, `worker.barrier()` waits for it.
    `spans` as in `compute_measurements_arrays`, plus `measure_inputs` (the
    files read or the images' device copies taken), `pfav` and `save`."""
    from boa_tpu_torch.io import nifti

    measurements: dict[str, Any] = {"segmentations": {}, "info": {}}
    if len(models) == 0:
        return measurements
    device = resolve_device(device)
    sp = Spans(spans, device)
    ct_img = ct_image if ct_image is not None else nifti.load(ct_path)
    ct_data = np.asarray(ct_img.data)
    segmentations = {}
    seg_devs = {}
    for model_name in models:
        file_name = ("total" if model_name == "total"
                     else ADDITIONAL_MODELS_OUTPUT_NAME.get(model_name, model_name))
        seg_img = (seg_images or {}).get(model_name)
        if seg_img is None:
            p = Path(segmentation_folder) / f"{file_name}.nii.gz"
            if not p.exists():
                continue
            seg_img = nifti.load(p)
            ci = ct_img.crop_info
            if ci is not None and seg_img.shape != ct_img.shape:
                # files are on the full grid, this run on the body crop
                seg_img = nifti.NiftiImage(
                    data=np.asarray(seg_img.data)[ci.x0:ci.x1, ci.y0:ci.y1],
                    affine=ct_img.affine.copy())
        if not np.allclose(seg_img.zooms, ct_img.zooms):
            raise ValueError(
                "The spacing of the image and of the segmentation should be the same")
        segmentations[model_name] = np.asarray(seg_img.data)
        seg_devs[model_name] = seg_img.device_data(device)
    ct_dev = ct_img.device_data(device)
    sp.mark("measure_inputs")
    out = compute_measurements_arrays(ct_data, segmentations, ct_img.zooms,
                                      cnr_adjustment, ct_dev=ct_dev, seg_devs=seg_devs,
                                      device=device, spans=spans)
    if "total" in segmentations:
        sp.restart()
        if ct_dev.dtype == torch.int16:
            pfav = _pfav_mask_device(ct_dev, seg_devs["total"])
        else:
            pfav = compute_pfav_mask(ct_data, segmentations["total"])
        sp.mark("pfav")
        img = nifti.NiftiImage(data=pfav, affine=ct_img.affine, crop_info=ct_img.crop_info)
        pfav_path = Path(segmentation_folder) / "ct_pfav.nii.gz"
        if worker is not None:
            fut = worker.submit("save-ct_pfav.nii.gz", nifti.save, img, pfav_path)
            if save_futures is not None:
                save_futures.append(fut)
        else:
            nifti.save(img, pfav_path)
        sp.mark("save")
    return out
