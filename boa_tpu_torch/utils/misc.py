"""Small shared utilities.

Counterpart of `boa_tpu/utils/misc.py` (body_organ_analysis
`compute/util.py`): the output names of the additional models, the slice
count after a resample, label masks, the workbook's CamelCase names and the
JSON hook for numpy values.
"""

from __future__ import annotations

import numpy as np

ADDITIONAL_MODELS_OUTPUT_NAME: dict[str, str] = {
    "lung_vessels": "lung_vessels_airways",
    "cerebral_bleed": "cerebral_bleed",
    "hip_implant": "hip_implant",
    "coronary_arteries": "coronary_arteries",
    "pleural_pericard_effusion": "pleural_pericard_effusion",
    "liver_vessels": "liver_vessels",
    "heartchambers_highres": "heartchambers",
}


def convert_resampling_slices(
    slices: int, current_sampling: float, target_resampling: float | None
) -> int:
    if target_resampling is None:
        return slices
    return round((slices / target_resampling) * current_sampling)


def create_mask(region_data: np.ndarray, labels) -> np.ndarray:
    if isinstance(labels, (int, np.integer)):
        return region_data == labels
    return np.isin(region_data, labels)


def convert_name(name: str) -> str:
    """snake_case -> CamelCase, as the workbook names models and regions."""
    return "".join(s.capitalize() for s in name.split("_"))


def np_json_default(o):
    """json.dump default= handler for numpy scalars/arrays."""
    if isinstance(o, np.integer):
        return int(o)
    if isinstance(o, np.floating):
        return float(o)
    if isinstance(o, np.bool_):
        return bool(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    raise TypeError(f"Object of type {o.__class__.__name__} "
                    f"is not JSON serializable")
