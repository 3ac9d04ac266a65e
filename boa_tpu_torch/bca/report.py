"""BCA report builder: per-slice tissue volumes, aggregations, findings and
the JSON and PDF reports.

Counterpart of `boa_tpu/bca/report.py` (body_composition_analysis
`report/builder.py`): `AggregatableBodyPart.from_body_regions` (abdomen
>= 200 mm of abdominal cavity, neck >= 100 mm above the mediastinum, thorax
>= 200 mm overlapping the abdomen), the aggregation groups, the per-group describe statistics with
each tissue's mean HU, the secondary findings with the breast implants,
`prepare`, `create_json` (the reference's schema, key for key) and
`create_pdf` (`bca/plots.py`, from `prepare`'s output alone).

Axes are (x, y, z) RAS, z the slice index as in the reference.

Device work: the per-slice pass (tissue voxel counts and HU sums, with and
without the limbs), the per-slice region counts and the tissue density
stacks are `torch.bincount`s over a key that combines the slice (and the
other axis) with the label id, in place of the reference's one-hot volumes.
On an H100 at 512x512x300 they beat a loop of one masked reduction per id
(`chip_smoke.py` phase 8 (b) times both). Counts are int64 and HU sums
float64, so both are exact and independent of the order of summation (the
reference sums float32). The tables the
reference keeps in DataFrames are numpy arrays and dicts here; pandas'
`describe` is computed with numpy to its definitions (std with ddof 1,
linear quantiles) and NaN becomes None, as in the reference.
"""

from __future__ import annotations

import enum
import logging
import math
from typing import Any

import numpy as np
import torch

from boa_tpu_torch.bca.definitions import ADIPOSE_TISSUES, BodyPart, BodyRegion, Tissue
from boa_tpu_torch.bca.plots import render_report_pdf
from boa_tpu_torch.device import resolve_device
from boa_tpu_torch.ops import connected_components as cc
from boa_tpu_torch.ops import packing
from boa_tpu_torch.utils.timing import Spans
from boa_tpu_torch.version import __version__

logger = logging.getLogger(__name__)

TISSUE_COLS = ["Bone", "Muscle", "TAT", "IMAT", "SAT", "VAT", "PAT", "EAT"]
_N_TISSUE = len(Tissue) + 1  # + background
# describe's rows (count dropped), the total and the mean HU, with their JSON names
_STAT_ROWS = {"Mean": "mean", "StdDev": "std", "Minimum": "min", "25%": "q1",
              "Median": "q2", "75%": "q3", "Maximum": "max", "Total": "sum",
              "MeanHU": "mean_hu"}
_THORAX = (int(BodyRegion.THORACIC_CAVITY), int(BodyRegion.MEDIASTINUM),
           int(BodyRegion.PERICARDIUM))


def _pretty_volume(value: float) -> str:
    if value >= 1000:
        return f"{value / 1000:.3f} L"
    return f"{value:.2f} mL"


class AggregatableBodyPart(enum.IntFlag):
    NONE = 0
    ABDOMEN = 1
    THORAX = 2
    NECK = 4

    @staticmethod
    def from_body_regions(region_data: np.ndarray, slice_thickness: float,
                          min_abdomen_length: float = 200,
                          min_neck_length: float = 100,
                          min_thorax_length: float = 200,
                          z_counts: np.ndarray | None = None
                          ) -> "AggregatableBodyPart":
        """The examined body parts. `z_counts`: the (nz, n_labels) per-slice
        region counts (`Builder.region_z_counts`), in place of scans of
        `region_data`."""
        result = AggregatableBodyPart.NONE
        nz = region_data.shape[2]

        def _presence(labels) -> np.ndarray:
            labels = np.atleast_1d(labels)
            if z_counts is not None:
                cols = [lb for lb in labels if lb < z_counts.shape[1]]
                if not cols:
                    return np.zeros(nz, bool)
                return z_counts[:, cols].sum(axis=1) > 0
            return np.isin(region_data, labels).any(axis=(0, 1))

        abdomen_any = _presence(int(BodyRegion.ABDOMINAL_CAVITY))
        abdomen_slices = np.where(abdomen_any)[0]
        n_abd = (abdomen_slices.max() - abdomen_slices.min() + 1
                 if abdomen_slices.size else 0)
        if n_abd * slice_thickness >= min_abdomen_length:
            result |= AggregatableBodyPart.ABDOMEN

        med_slices = np.where(_presence(int(BodyRegion.MEDIASTINUM)))[0]
        n_above = nz - med_slices.max() if med_slices.size else 0
        if n_above * slice_thickness >= min_neck_length:
            result |= AggregatableBodyPart.NECK

        thorax_any = _presence(list(_THORAX))
        thorax_slices = np.where(thorax_any)[0]
        n_tho = (thorax_slices.max() - thorax_slices.min() + 1
                 if thorax_slices.size else 0)
        has_overlap = bool(np.logical_and(abdomen_any, thorax_any).any())
        if has_overlap and n_tho * slice_thickness >= min_thorax_length:
            result |= AggregatableBodyPart.THORAX
        return result


# ---------------------------------------------------------------------------
# device passes
# ---------------------------------------------------------------------------


def _slicewise_pass(ct: torch.Tensor, tissues: torch.Tensor, torso: torch.Tensor):
    """(counts, husums, counts_nl, husums_nl): (nz, n_tissue) numpy arrays,
    int64 voxel counts and float64 HU sums per slice and tissue id, over the
    whole slice and over the torso (`torso`, bool) only. Two bincounts over
    the key slice * n_tissue + id, offset by one table for the torso's
    voxels: the torso's table, and the sum of both. (A single bin for every
    voxel outside the torso took three times as long on an H100: its atomics
    contend.)"""
    nz = tissues.shape[2]
    bins = nz * _N_TISSUE
    z = torch.arange(nz, device=tissues.device)
    key = (z * _N_TISSUE + tissues.long() + torso * bins).reshape(-1)
    counts = torch.bincount(key, minlength=2 * bins).reshape(2, nz, _N_TISSUE)
    husums = torch.bincount(key, weights=ct.reshape(-1).to(torch.float64),
                            minlength=2 * bins).reshape(2, nz, _N_TISSUE)
    out = (counts.sum(0), husums.sum(0), counts[1], husums[1])
    return tuple(o.cpu().numpy() for o in out)


def _tissue_density_pass(tissues: torch.Tensor, axis: int) -> np.ndarray:
    """(n_tissues, h, w) float32 share of each tissue along `axis` (0 or 1),
    (h, w) the other in-plane axis and z: one bincount over the key
    (id, other axis, z), background's bins dropped."""
    depth = tissues.shape[axis]
    n_other, nz = tissues.shape[1 - axis], tissues.shape[2]
    pos = torch.arange(n_other, device=tissues.device)
    pos = pos.view(-1, 1, 1) if axis == 1 else pos.view(1, -1, 1)
    key = (tissues.long() * n_other + pos) * nz + torch.arange(nz, device=tissues.device)
    counts = torch.bincount(key.reshape(-1), minlength=_N_TISSUE * n_other * nz)
    counts = counts[n_other * nz:].reshape(_N_TISSUE - 1, n_other, nz)
    return (counts.to(torch.float32) / depth).cpu().numpy()


def _region_z_pass(regions: torch.Tensor, width: int) -> np.ndarray:
    """(nz, width) int64 voxel count per slice of each region id < width:
    one bincount over the key slice * (width + 1) + id, the ids >= width in
    a last column that is dropped."""
    nz = regions.shape[2]
    z = torch.arange(nz, device=regions.device)
    key = z * (width + 1) + regions.long().clamp(max=width)
    counts = torch.bincount(key.reshape(-1), minlength=nz * (width + 1))
    return counts.reshape(nz, width + 1)[:, :width].cpu().numpy()


def _tissue_name(t: Tissue) -> str:
    return t.name.capitalize() if t in (Tissue.BONE, Tissue.MUSCLE) else t.name


def _json_value(v) -> float | None:
    v = float(v)
    return None if math.isnan(v) else v


class Builder:
    """Report builder over (x, y, z) RAS arrays on one grid.

    `ct_data` is numpy or a tensor on `device`; `tissues_dev` and
    `regions_dev` are the device copies of `tissues` and `body_regions`
    where the caller has them (else they are uploaded). `device` defaults to
    the card. `spans`, when given, receives the seconds of `builder.upload`
    and `builder.slicewise`."""

    def __init__(self, ct_data, body_parts: np.ndarray, body_regions: np.ndarray,
                 tissues: np.ndarray, spacing: tuple[float, float, float],
                 theme: str = "light", tissues_dev: torch.Tensor | None = None,
                 regions_dev: torch.Tensor | None = None, device=None,
                 spans: dict | None = None):
        self.device = resolve_device(device)
        sp = Spans(spans, self.device)
        self._ct = ct_data
        self._parts = np.asarray(body_parts)
        self._regions = np.asarray(body_regions)
        self._tissues = np.asarray(tissues)
        self.spacing = tuple(float(s) for s in spacing)
        self.theme = theme
        self.examined_body_part = AggregatableBodyPart(0)
        if tissues_dev is None:
            tissues_dev = packing.upload_labels(self._tissues, 255, self.device)
        if regions_dev is None:
            regions_dev = packing.upload_labels(self._regions, 255, self.device)
        self._tissues_dev, self._regions_dev = tissues_dev, regions_dev
        self._region_zc: np.ndarray | None = None
        ct_dev = (ct_data if isinstance(ct_data, torch.Tensor)
                  else packing.upload_ct(ct_data, self.device))
        torso = packing.upload_labels(self._parts, 255, self.device) == int(BodyPart.TORSO)
        sp.mark("builder.upload")
        self._counts, self._husums, self._counts_nl, self._husums_nl = \
            _slicewise_pass(ct_dev, tissues_dev, torso)
        sp.mark("builder.slicewise")

    def axial_ct_slices(self, idxs, stride: int = 1) -> np.ndarray:
        """(x / stride, y / stride, len(idxs)) CT slices on the host; a CT on
        the device sends only those slices."""
        idxs = np.asarray(idxs, np.int64)
        if isinstance(self._ct, np.ndarray):
            return np.ascontiguousarray(self._ct[::stride, ::stride, idxs])
        sel = torch.from_numpy(idxs).to(self._ct.device)
        return self._ct[::stride, ::stride].index_select(2, sel).cpu().numpy()

    # -- per-slice region counts: every cavity range and volume derives
    #    from this one pass
    def region_z_counts(self) -> np.ndarray:
        """(nz, width) voxel counts per slice of each region id below
        width = min(max id + 1, 16); the 255 fragments count nowhere."""
        if self._region_zc is None:
            width = min(int(self._regions.max()) + 1, 16)
            self._region_zc = _region_z_pass(self._regions_dev, width)
        return self._region_zc

    def _region_presence_z(self, labels) -> np.ndarray:
        zc = self.region_z_counts()
        cols = [lb for lb in np.atleast_1d(labels) if lb < zc.shape[1]]
        if not cols:
            return np.zeros(zc.shape[0], bool)
        return zc[:, cols].sum(axis=1) > 0

    def _region_volume_ml(self, labels) -> float:
        zc = self.region_z_counts()
        cols = [lb for lb in np.atleast_1d(labels) if lb < zc.shape[1]]
        ml_per_voxel = float(np.prod(self.spacing)) / 1000.0
        return float(zc[:, cols].sum()) * ml_per_voxel if cols else 0.0

    # -- per-slice tables: {"slice_idx", *TISSUE_COLS} -> (nz,) arrays ------
    def _slicewise_table(self, counts: np.ndarray) -> dict[str, np.ndarray]:
        ml_per_voxel = float(np.prod(self.spacing)) / 1000.0
        data = {_tissue_name(t): counts[:, int(t)] * ml_per_voxel for t in Tissue}
        data["TAT"] = data["SAT"] + data["VAT"] + data["IMAT"] + data["PAT"] + data["EAT"]
        return {"slice_idx": np.arange(len(counts)), **{c: data[c] for c in TISSUE_COLS}}

    def slicewise_measurements(self) -> dict[str, np.ndarray]:
        return self._slicewise_table(self._counts)

    def slicewise_measurements_no_limbs(self) -> dict[str, np.ndarray]:
        return self._slicewise_table(self._counts_nl)

    # -- aggregation groups ---------------------------------------------------
    def aggregation_groups(self, vertebrae: dict[str, tuple[int, int]] | None
                           ) -> list[tuple[str, int, int]]:
        groups = [("Whole Scan", 0, self._regions.shape[2])]

        def _range(presence_z) -> tuple[int, int]:
            slices = np.where(presence_z)[0]
            return int(slices.min()), int(slices.max() + 1)

        if AggregatableBodyPart.ABDOMEN in self.examined_body_part:
            groups.append(("Abdominal Cavity", *_range(
                self._region_presence_z(int(BodyRegion.ABDOMINAL_CAVITY)))))
        if AggregatableBodyPart.THORAX in self.examined_body_part:
            groups.append(("Thoracic Cavity", *_range(self._region_presence_z(list(_THORAX)))))
            groups.append(("Mediastinum", *_range(
                self._region_presence_z(int(BodyRegion.MEDIASTINUM)))))
            groups.append(("Pericardium", *_range(
                self._region_presence_z(int(BodyRegion.PERICARDIUM)))))
        if (AggregatableBodyPart.ABDOMEN in self.examined_body_part
                and AggregatableBodyPart.THORAX in self.examined_body_part):
            groups.insert(1, ("Ventral Cavity", groups[1][1], groups[2][2]))
        if vertebrae:
            for name, (lo, hi) in vertebrae.items():
                groups.append((name, lo, hi))
        return groups

    # -- describe statistics of one group -------------------------------------
    def _group_stats(self, table: dict[str, np.ndarray], counts: np.ndarray,
                     husums: np.ndarray, lo: int, hi: int) -> dict[str, dict]:
        """{column: {row: float or None}} over the slices [lo, hi): pandas'
        describe (mean, std with ddof 1, min, linear quartiles, max), the
        total and the mean HU of each tissue (TAT over the adipose ones)."""
        hu = {}
        for t in Tissue:
            cnt = counts[lo:hi, int(t)].sum()
            hu[_tissue_name(t)] = husums[lo:hi, int(t)].sum() / cnt if cnt else np.nan
        tat_cnt = sum(counts[lo:hi, int(t)].sum() for t in ADIPOSE_TISSUES)
        tat_sum = sum(husums[lo:hi, int(t)].sum() for t in ADIPOSE_TISSUES)
        hu["TAT"] = tat_sum / tat_cnt if tat_cnt else np.nan
        stats = {}
        for col in TISSUE_COLS:
            v = table[col][lo:hi]
            if len(v):
                q1, q2, q3 = np.quantile(v, (0.25, 0.5, 0.75))
                row = (v.mean(), v.std(ddof=1) if len(v) > 1 else np.nan, v.min(),
                       q1, q2, q3, v.max())
            else:
                row = (np.nan,) * 7
            row += (v.sum(), hu[col])
            stats[col] = {name: _json_value(x) for name, x in zip(_STAT_ROWS, row)}
        return stats

    def generate_aggregated_measurements(self, vertebrae) -> list[tuple]:
        table = self.slicewise_measurements()
        table_nl = self.slicewise_measurements_no_limbs()
        result = []
        for name, lo, hi in self.aggregation_groups(vertebrae):
            stats = self._group_stats(table, self._counts, self._husums, lo, hi)
            stats_nl = self._group_stats(table_nl, self._counts_nl, self._husums_nl, lo, hi)
            result.append((name, (lo, hi), None, stats, stats_nl))
        return result

    # -- secondary findings ---------------------------------------------------
    def generate_secondary_findings(self) -> list[str]:
        result = []
        ml_per_voxel = float(np.prod(self.spacing)) / 1000.0
        if AggregatableBodyPart.ABDOMEN in self.examined_body_part:
            vol = self._region_volume_ml(int(BodyRegion.ABDOMINAL_CAVITY))
            result.append(f"Total volume of the abdominal cavity is {_pretty_volume(vol)}")
        if AggregatableBodyPart.THORAX in self.examined_body_part:
            vol = self._region_volume_ml(list(_THORAX))
            result.append(f"Volume of thoracic cavity is {_pretty_volume(vol)}")
            vol = self._region_volume_ml([int(BodyRegion.MEDIASTINUM),
                                          int(BodyRegion.PERICARDIUM)])
            result.append(f"Volume of mediastinum is {_pretty_volume(vol)}")
            vol = self._region_volume_ml(int(BodyRegion.PERICARDIUM))
            result.append("Volume enclosed by the pericardial sack is "
                          f"{_pretty_volume(vol)}")
            result.extend(self._breast_implant_findings(ml_per_voxel))
        return result

    def _breast_implant_findings(self, ml_per_voxel: float) -> list[str]:
        mask = self._regions == int(BodyRegion.BREAST_IMPLANT)
        if not mask.any():
            return []
        labels, n = cc.label(mask, connectivity=3)
        # every component's volume and x centroid in one pass each (a noisy
        # map has thousands of speckle components)
        counts = np.bincount(labels.ravel(), minlength=n + 1).astype(np.float64)
        xs = np.arange(labels.shape[0], dtype=np.float64)[:, None, None]
        xsums = np.bincount(labels.ravel(), weights=np.broadcast_to(xs, labels.shape).ravel(),
                            minlength=n + 1)
        implants = []
        mid = self._regions.shape[0] // 2
        for comp in range(1, n + 1):
            vol = counts[comp] * ml_per_voxel
            if vol > 10:
                implants.append((xsums[comp] / counts[comp], vol))
        if not implants:
            return []  # only speckle below 10 mL: no finding
        # the patient's right first: descending x in RAS
        implants.sort(key=lambda t: -t[0])
        named = [("right" if cx >= mid else "left", vol) for cx, vol in implants]
        if len(named) == 1:
            return [f"Patient has a single breast implant on the {named[0][0]} "
                    f"side with volume of {_pretty_volume(named[0][1])}"]
        if len(named) == 2:
            return [f"Patient has two breast implants with volume of "
                    f"{_pretty_volume(named[0][1])} ({named[0][0]}) and "
                    f"{_pretty_volume(named[1][1])} ({named[1][0]})"]
        logger.error("More than two breast implant segments found")
        return []

    # -- prepare + JSON -------------------------------------------------------
    def prepare(self, vertebrae=None, total=None,
                total_measurements: dict | None = None) -> dict[str, Any]:
        """Everything the JSON and the PDF read: the per-slice tables, the
        aggregations, the findings, `total`'s present measurements keyed by
        their title-case names, the heatmap density stacks (axes 1 and 0)
        and the CT and tissue slices of the PDF's overlay pages."""
        table = self.slicewise_measurements()
        table_nl = self.slicewise_measurements_no_limbs()
        aggregations = self.generate_aggregated_measurements(vertebrae)

        measurements_total = None
        if (total_measurements is not None and "segmentations" in total_measurements
                and "total" in total_measurements["segmentations"]):
            # {name: {column: value}}: every row has every column (in the
            # order they first appear), None where its entry lacks one
            entries = total_measurements["segmentations"]["total"]
            columns = list(dict.fromkeys(k for e in entries.values() for k in e
                                         if k != "present"))
            renamed = {"25th_percentile_hu": "twentyfive_percentile_hu",
                       "75th_percentile_hu": "seventyfive_percentile_hu"}
            measurements_total = {
                name.replace("_", " ").title(): {renamed.get(k, k): entry.get(k)
                                                 for k in columns}
                for name, entry in entries.items() if entry.get("present")}

        nz = self._regions.shape[2]
        chk = np.linspace(0, nz - 1, min(12, nz)).round().astype(np.int64)
        mids = [int((lo + hi) // 2) for _, (lo, hi), *_ in aggregations]
        all_idx = np.concatenate([chk, np.asarray(mids, np.int64)])
        # the overlay panels at about 256 pixels a side
        ds = max(1, min(self._regions.shape[0], self._regions.shape[1]) // 256)
        slice_check = {
            "check_idxs": chk,
            "mid_idxs": mids,
            "ct_slices": self.axial_ct_slices(all_idx, stride=ds),
            "tissue_slices": self._tissues[::ds, ::ds, all_idx],
        }
        density = {ax: _tissue_density_pass(self._tissues_dev, ax) for ax in (1, 0)}
        return {
            "tissue_density": density,
            "aggregated_measurements": aggregations,
            "equidistant_slice_check": slice_check,
            "image_summary": None,
            "other_findings": self.generate_secondary_findings(),
            "slicewise_measurements": table,
            "slicewise_measurements_no_limbs": table_nl,
            "measurements_total": measurements_total,
            "tissue_heatmaps": None,
            "summary_totalsegmentator": None,
        }

    def create_json(self, **kwargs: Any) -> dict[str, Any]:
        def _records(table: dict[str, np.ndarray]) -> list[dict[str, float]]:
            cols = [(c.lower(), table[c]) for c in TISSUE_COLS]
            return [{name: float(v[i]) for name, v in cols}
                    for i in range(len(table["slice_idx"]))]

        def _rename_stats(stats: dict[str, dict]) -> dict:
            return {col.lower(): {_STAT_ROWS[row]: v for row, v in rows.items()}
                    for col, rows in stats.items()}

        return {
            "slices": _records(kwargs["slicewise_measurements"]),
            "slices_no_extremities": _records(kwargs["slicewise_measurements_no_limbs"]),
            "aggregated": {
                name.lower().replace(" ", "_").replace("-", "_"): {
                    "num_slices": int(hi - lo),
                    "min_slice_idx": int(lo),
                    "max_slice_idx": int(hi),
                    "measurements": _rename_stats(stats),
                    "measurements_no_extremities": _rename_stats(stats_nl),
                }
                for name, (lo, hi), _, stats, stats_nl in kwargs["aggregated_measurements"]
            },
            "body_parts": {
                "abdomen": AggregatableBodyPart.ABDOMEN in self.examined_body_part,
                "neck": AggregatableBodyPart.NECK in self.examined_body_part,
                "thorax": AggregatableBodyPart.THORAX in self.examined_body_part,
            },
        }

    def create_pdf(self, **prepared) -> bytes:
        """The PDF report from `prepare`'s output alone (`bca/plots.py`)."""
        return render_report_pdf(self, prepared, version=__version__)


def create_vertebrae_info(total_seg: np.ndarray,
                          detected_body_part: AggregatableBodyPart,
                          class_map_total: dict[int, str]) -> dict[str, tuple[int, int]]:
    """Per-vertebra z slice ranges [lo, hi) of the vertebrae in the examined
    body parts (cervical with the neck, thoracic with the thorax, lumbar with
    the abdomen)."""
    vertebrae_map = {name.removeprefix("vertebrae_"): idx
                     for idx, name in class_map_total.items()
                     if name.startswith("vertebrae_")}
    if not vertebrae_map:
        return {}
    # vertebra voxels are a small share of the scan: one range mask, then a
    # bincount over those voxels only
    nz = total_seg.shape[2]
    vals = sorted(vertebrae_map.values())
    vmin, vmax = vals[0], vals[-1]
    width = vmax - vmin + 1
    seg_flat = np.ascontiguousarray(total_seg).ravel()
    hits = np.flatnonzero((seg_flat >= vmin) & (seg_flat <= vmax))
    z = (hits % nz).astype(np.int64)
    lab = seg_flat[hits].astype(np.int64) - vmin
    presence = np.bincount(z * width + lab, minlength=nz * width).reshape(nz, width) > 0
    info: dict[str, tuple[int, int]] = {}
    for vid, label in vertebrae_map.items():
        zs = np.where(presence[:, label - vmin])[0]
        if len(zs) == 0:
            continue
        if (("C" in vid and AggregatableBodyPart.NECK not in detected_body_part)
                or ("T" in vid and AggregatableBodyPart.THORAX not in detected_body_part)
                or ("L" in vid and AggregatableBodyPart.ABDOMEN not in detected_body_part)):
            continue
        info[vid] = (int(zs.min()), int(zs.max() + 1))
    return info
