"""Segmentation label tables.

Counterpart of `boa_tpu/tasks/class_maps.py`; `data/class_maps.json` is a
copy of the reference's data: the 50 task label maps (`total` = 117
classes, label 0 is background), `class_map_5_parts` (the split of `total`
into the outputs of its five sub-models), `map_taskid_to_partname_ct` and
`commercial_models`. The BCA label definitions are not ported yet.
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
