"""Segmentation label tables.

Counterpart of `boa_tpu/tasks/class_maps.py`; `data/class_maps.json` is a
copy of the reference's data: the 50 task label maps (`total` = 117
classes, label 0 is background), `class_map_5_parts` (the split of `total`
into the outputs of its five sub-models), `map_taskid_to_partname_ct` and
`commercial_models`. `data/bca_definitions.json` is a copy of the BCA
label definitions: 11 body regions, 7 body parts (with background), 7
tissues, the HU ranges and the tissue = HU-range ∩ body-region rules.
"""

from __future__ import annotations

import json
from pathlib import Path


def _int_keys(table: dict) -> dict:
    return {name: {int(i): v for i, v in labels.items()}
            for name, labels in table.items()}


with open(Path(__file__).parent / "data" / "class_maps.json") as _f:
    _RAW = json.load(_f)

class_map: dict[str, dict[int, str]] = _int_keys(_RAW["class_map"])
class_map_5_parts: dict[str, dict[int, str]] = _int_keys(_RAW["class_map_5_parts"])
map_taskid_to_partname: dict[int, str] = {
    int(tid): part for tid, part in _RAW["map_taskid_to_partname_ct"].items()}
commercial_models: dict = dict(_RAW["commercial_models"])
del _RAW


def get_class_map(task_name: str) -> dict[int, str]:
    return dict(class_map[task_name])


with open(Path(__file__).parent / "data" / "bca_definitions.json") as _f:
    _BCA = json.load(_f)


def bca_body_regions() -> dict[str, int]:
    """The 11 body-region labels."""
    return dict(_BCA["body_regions"])


def bca_body_parts() -> dict[str, int]:
    """The 7 body-part labels, background included."""
    return dict(_BCA["body_parts"])


def bca_tissues() -> dict[str, int]:
    """The 7 tissue classes."""
    return dict(_BCA["tissues"])


def bca_hu_ranges() -> dict[str, tuple[float, float]]:
    return {k: tuple(v) for k, v in _BCA["hu_ranges"].items()}


def bca_tissue_rules() -> list[dict[str, str]]:
    """The tissue = HU-range ∩ body-region table, in the order it applies."""
    return [dict(r) for r in _BCA["tissue_derivation_rules"]]
