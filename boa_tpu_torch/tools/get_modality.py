"""CT vs MR modality prediction from image-level intensity features.

Counterpart of `boa_tpu/tools/get_modality.py` (TotalSegmentator
`bin/totalseg_get_modality.py:24-111`): four features (mean, std, min, max
of the raw intensities) -> the reference's 5-fold XGBoost ensemble
(`boa_tpu_torch/resources/modality_classifiers_2025_02_24.json.*`, byte
copies, scored by the numpy tree walker of `compute/xgb.py`). With `-n`,
the fast `total_mr` model runs on the card (`python_api.totalsegmentator`)
and the median normalized intensities of 16 organs are scored by the
normalized folds. `BOA_MODALITY_MODEL` names a pickled sklearn-style
ensemble instead (a pickle is trusted code). The folds ship with the
package, so the reference's HU-range rule for missing folds is not kept.

    python -m boa_tpu_torch.tools.get_modality -i image.nii.gz -o modality.json [-n]
    ... -d cpu      # on the host; the default is the card (-d gpu)
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
from functools import lru_cache
from pathlib import Path

import numpy as np

from boa_tpu_torch.compute.xgb import load_fold_files
from boa_tpu_torch.device import named_device

_VENDORED_FOLDS = (Path(__file__).resolve().parents[1] / "resources" /
                   "modality_classifiers_2025_02_24.json")


def get_features(data: np.ndarray) -> list[float]:
    return [float(np.mean(data)), float(np.std(data)),
            float(np.min(data)), float(np.max(data))]


@lru_cache(maxsize=1)
def _vendored_ensemble():
    return load_fold_files(_VENDORED_FOLDS)


def get_modality(data: np.ndarray, model_file: str | Path | None = None) -> dict:
    features = get_features(np.asarray(data))
    model_file = model_file or os.environ.get("BOA_MODALITY_MODEL")
    if model_file and not Path(model_file).exists():
        # a typo'd model path must not silently degrade to the heuristic
        raise FileNotFoundError(f"BOA_MODALITY_MODEL={model_file} not found")
    if model_file:
        with open(model_file, "rb") as f:
            clfs = pickle.load(f)
        preds = [float(c.predict(np.asarray(features)[None])[0])
                 for c in (clfs.values() if isinstance(clfs, dict) else clfs)]
        prob = float(np.mean(preds))
        modality = "mr" if prob > 0.5 else "ct"
        probability = prob if modality == "mr" else 1 - prob
    else:
        # the reference's ensemble semantics (`totalseg_get_modality.py:49-60`):
        # mean of the fold *labels*, < 0.5 -> ct
        labels = [float(fold.predict_label([features])[0])
                  for fold in _vendored_ensemble()]
        mean_label = float(np.mean(labels))
        modality = "ct" if mean_label < 0.5 else "mr"
        probability = 1 - mean_label if modality == "ct" else mean_label
    return {"modality": modality, "probability": round(probability, 4),
            "features": features}


# ROI-median features of the min-max-normalized image, in the reference's
# order (`totalseg_get_modality.py:76-81`)
ROI_ORGANS = (
    "brain", "esophagus", "colon", "spinal_cord",
    "scapula_left", "scapula_right",
    "femur_left", "femur_right", "hip_left", "hip_right",
    "gluteus_maximus_left", "gluteus_maximus_right",
    "autochthon_left", "autochthon_right",
    "iliopsoas_left", "iliopsoas_right")

_NORMALIZED_FOLDS = (Path(__file__).resolve().parents[1] / "resources" /
                     "modality_classifiers_normalized_2025_02_24.json")


@lru_cache(maxsize=1)
def _normalized_ensemble():
    return load_fold_files(_NORMALIZED_FOLDS)


def get_modality_from_rois(img, fake_predict=None, *, store=None, device="gpu") -> dict:
    """Modality from normalized ROI-median intensities
    (`totalseg_get_modality.py:67-111`): the fast `total_mr` model with
    median statistics over the min-max-normalized volume on `device` (the
    card by default), the 16 reference organs' intensities scored by the
    normalized 5-fold ensemble. `img` is a NiftiImage or a path;
    `fake_predict` is the pipeline's test hook."""
    from boa_tpu_torch.python_api import totalsegmentator

    _, stats = totalsegmentator(
        img, None, ml=True, fast=True, statistics=True, task="total_mr",
        roi_subset=None, statistics_exclude_masks_at_border=False,
        quiet=True, stats_aggregation="median",
        statistics_normalized_intensities=True, skip_saving=True,
        device=str(device), fake_predict=fake_predict, store=store)
    features = [float(stats[o]["intensity"]) for o in ROI_ORGANS]
    labels = [float(fold.predict_label([features])[0]) for fold in _normalized_ensemble()]
    mean_label = float(np.mean(labels))
    modality = "ct" if mean_label < 0.5 else "mr"
    probability = 1 - mean_label if modality == "ct" else mean_label
    return {"modality": modality, "probability": round(probability, 4),
            "features": features}


def main(argv=None, *, store=None, fake_predict=None) -> None:
    """The command. `store` and `fake_predict` (the pipeline's test hook)
    are for callers in Python, not on the command line."""
    from boa_tpu_torch.io import nifti

    ap = argparse.ArgumentParser("totalseg_get_modality")
    ap.add_argument("-i", "--input", type=Path, required=True)
    ap.add_argument("-o", "--output", type=Path, default=None)
    ap.add_argument("-n", dest="normalized_intensities", action="store_true",
                    help="use normalized ROI intensities (for images that "
                    "no longer contain original HU values)", default=False)
    ap.add_argument("-d", "--device", default="gpu",
                    help="gpu (the card, default), gpu:N or cpu")
    args = ap.parse_args(argv)
    device = named_device(args.device)
    img = nifti.load(args.input)
    if args.normalized_intensities:
        res = get_modality_from_rois(img, fake_predict, store=store, device=device)
    else:
        res = get_modality(np.asarray(img.data))
    print(json.dumps(res, indent=2))
    if args.output:
        args.output.write_text(json.dumps(res, indent=2))


if __name__ == "__main__":
    main()
