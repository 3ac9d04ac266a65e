"""Segmentation label tables.

Counterpart of `boa_tpu/tasks/class_maps.py`; `data/class_maps.json` holds
the 117-class `total` map (label 0 is background) that the ported tasks
use.
"""

from __future__ import annotations

import json
from functools import lru_cache
from pathlib import Path

_DATA = Path(__file__).parent / "data"


@lru_cache(maxsize=1)
def _load() -> dict:
    with open(_DATA / "class_maps.json") as f:
        raw = json.load(f)
    return {task: {int(i): name for i, name in labels.items()}
            for task, labels in raw["class_map"].items()}


def get_class_map(task_name: str) -> dict[int, str]:
    return dict(_load()[task_name])
