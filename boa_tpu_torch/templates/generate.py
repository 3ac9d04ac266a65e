"""Generate dcmqi-style DICOM-SEG metainfo templates.

Counterpart of `boa_tpu/templates/generate.py`: the 12 templates of upstream
`body_organ_analysis/templates/*-meta.json`, one per output kind, generated
from the class maps so that labels never drift from the models. Each organ
gets its SNOMED property type, modifier and anatomic-region codes and its
display colour from the mapping table beside this file (TotalSegmentator's
`totalsegmentator_snomed_mapping.csv`). Run `python -m
boa_tpu_torch.templates.generate` to (re)write them next to this file.
"""

from __future__ import annotations

import colorsys
import csv
import json
from functools import lru_cache
from pathlib import Path

from boa_tpu_torch.io.storage import SEG_OUTPUT_KINDS, _label_map_for_kind
from boa_tpu_torch.utils.constants import SERIES_DESCRIPTIONS

_SNOMED_CSV = Path(__file__).parent / "snomed_mapping.csv"

#: CSV column prefix -> dcmqi segment attribute (code sequences)
_CODE_SEQUENCES = (
    "SegmentedPropertyCategoryCodeSequence",
    "SegmentedPropertyTypeCodeSequence",
    "SegmentedPropertyTypeModifierCodeSequence",
    "AnatomicRegionSequence",
    "AnatomicRegionModifierSequence",
)


@lru_cache(maxsize=1)
def snomed_mapping() -> dict[str, dict]:
    """structure name -> {code sequences..., 'rgb': [r, g, b]}."""
    if not _SNOMED_CSV.exists():
        return {}
    table: dict[str, dict] = {}
    with _SNOMED_CSV.open(newline="") as fh:
        for row in csv.DictReader(fh):
            entry: dict = {}
            for seq in _CODE_SEQUENCES:
                value = row.get(f"{seq}.CodeValue", "")
                if not value:
                    continue
                entry[seq] = {
                    "CodeValue": value,
                    "CodingSchemeDesignator": row[f"{seq}.CodingSchemeDesignator"],
                    "CodeMeaning": row[f"{seq}.CodeMeaning"],
                }
            rgb = row.get("DicomRGBColor", "")
            if rgb:
                entry["rgb"] = [int(v) for v in rgb.split(",")]
            table[row["Structure"]] = entry
    return table


def _color(i: int, n: int) -> list[int]:
    r, g, b = colorsys.hsv_to_rgb((i / max(n, 1)) % 1.0, 0.65, 0.9)
    return [int(r * 255), int(g * 255), int(b * 255)]


def template_for_kind(kind: str) -> dict | None:
    label_map = _label_map_for_kind(kind)
    if not label_map:
        return None
    labels = sorted(label_map)
    segments = []
    mapping = snomed_mapping()
    for i, lb in enumerate(labels):
        if lb == 0:
            continue
        codes = mapping.get(label_map[lb], {})
        seg = {
            "labelID": int(lb),
            "SegmentLabel": label_map[lb],
            "SegmentDescription": label_map[lb],
            "SegmentAlgorithmType": "AUTOMATIC",
            "SegmentAlgorithmName": "BOA-TPU",
            "recommendedDisplayRGBValue": codes.get("rgb", _color(i, len(labels))),
            "SegmentedPropertyCategoryCodeSequence": codes.get(
                "SegmentedPropertyCategoryCodeSequence", {
                    "CodeValue": "123037004",
                    "CodingSchemeDesignator": "SCT",
                    "CodeMeaning": "Anatomical Structure",
                }),
            # generic fallback for structures outside the SNOMED table
            # (tissues, body regions): SCT 85756007 "Body tissue"
            "SegmentedPropertyTypeCodeSequence": codes.get(
                "SegmentedPropertyTypeCodeSequence", {
                    "CodeValue": "85756007",
                    "CodingSchemeDesignator": "SCT",
                    "CodeMeaning": "Body tissue",
                }),
        }
        for optional_seq in ("SegmentedPropertyTypeModifierCodeSequence",
                             "AnatomicRegionSequence",
                             "AnatomicRegionModifierSequence"):
            if optional_seq in codes:
                seg[optional_seq] = codes[optional_seq]
        segments.append(seg)
    return {
        "ContentCreatorName": "BOA-TPU",
        "ClinicalTrialSeriesID": "Session1",
        "ClinicalTrialTimePointID": "1",
        "SeriesDescription": SERIES_DESCRIPTIONS.get(kind, kind),
        "SeriesNumber": "300",
        "InstanceNumber": "1",
        "BodyPartExamined": "",
        "segmentAttributes": [segments],
        "ContentLabel": "SEGMENTATION",
        "ContentDescription": "Image segmentation",
        "ClinicalTrialCoordinatingCenterName": "",
    }


def write_all(out_dir: str | Path | None = None) -> list[Path]:
    out_dir = Path(out_dir) if out_dir else Path(__file__).parent
    written = []
    for kind in SEG_OUTPUT_KINDS:
        tpl = template_for_kind(kind)
        if tpl is None:
            continue
        p = out_dir / f"{kind}-meta.json"
        p.write_text(json.dumps(tpl, indent=2))
        written.append(p)
    return written


if __name__ == "__main__":
    for p in write_all():
        print(p)
