"""Dataset fingerprint extraction, on the host.

Counterpart of `boa_tpu/engine/fingerprint.py` (nnU-Net's
`fingerprint_extractor.py`): per-case spacings, shapes after the nonzero
crop and foreground-voxel intensities (10k samples per case), pooled into
mean / std / median / min / max and the 0.5 and 99.5 percentiles.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Iterable

import numpy as np

from boa_tpu_torch.ops import preprocess as pp

NUM_FOREGROUND_SAMPLES_PER_CASE = 10_000


def case_fingerprint(data: np.ndarray, seg: np.ndarray | None,
                     spacing, seed: int = 1234) -> dict:
    """One case: crop shape + sampled foreground intensities."""
    rng = np.random.RandomState(seed)
    bbox = pp.nonzero_bbox(np.asarray(data, np.float32))
    shape_after_crop = tuple(int(b[1] - b[0]) for b in bbox)
    if seg is not None and (seg > 0).any():
        fg = data[seg > 0]
    else:
        fg = data[data != 0]
    if len(fg) > NUM_FOREGROUND_SAMPLES_PER_CASE:
        fg = fg[rng.choice(len(fg), NUM_FOREGROUND_SAMPLES_PER_CASE,
                           replace=False)]
    return {
        "spacing": [float(s) for s in spacing],
        "shape_after_crop": list(shape_after_crop),
        "foreground_intensities": np.asarray(fg, np.float64),
    }


def extract_fingerprint(cases: Iterable[tuple[np.ndarray, np.ndarray | None,
                                              tuple]],
                        out_file: str | Path | None = None) -> dict:
    """cases: iterable of (data, seg|None, spacing)."""
    spacings, shapes, intensities = [], [], []
    for data, seg, spacing in cases:
        fp = case_fingerprint(np.asarray(data), seg, spacing)
        spacings.append(fp["spacing"])
        shapes.append(fp["shape_after_crop"])
        intensities.append(fp["foreground_intensities"])
    allv = np.concatenate(intensities) if intensities else np.zeros(1)
    if allv.size == 0:  # every case had zero foreground samples
        allv = np.zeros(1)
    fingerprint = {
        "spacings": spacings,
        "shapes_after_crop": shapes,
        "foreground_intensity_properties_per_channel": {
            "0": {
                "mean": float(np.mean(allv)),
                "std": float(np.std(allv)),
                "median": float(np.median(allv)),
                "min": float(np.min(allv)),
                "max": float(np.max(allv)),
                "percentile_00_5": float(np.percentile(allv, 0.5)),
                "percentile_99_5": float(np.percentile(allv, 99.5)),
            }
        },
    }
    if out_file:
        Path(out_file).write_text(json.dumps(fingerprint, indent=2))
    return fingerprint
