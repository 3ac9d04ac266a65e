"""CT contrast phase from organ HU statistics (pi-time regression).

Counterpart of the library part of `boa_tpu/tools/get_phase.py`
(TotalSegmentator `bin/totalseg_get_phase.py:23-120`): per-organ median HU
features (plus the head and neck vessels when given) -> the vendored
regressor folds (`boa_tpu_torch/resources/contrast_phase_classifiers_2024_07_19.pkl`,
scored by `compute/xgb.py`) predict the pi-time -> `pi_time_to_phase`.
`BOA_PHASE_MODEL` names another pickle, or ``heuristic`` for the
aorta/portal rule. The command (`main`, the reference's `:145-180`) runs
the fast `total` model with median statistics through the port's
`predict_image` on the card, and `headneck_bones_vessels` for the four
vessel features when the brain's volume is over 100 (`:166`).

    python -m boa_tpu_torch.tools.get_phase -i ct.nii.gz -o phase.json [-m model.pkl]
    ... -d cpu      # on the host; the default is the card (-d gpu)
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import pickle
from pathlib import Path
from typing import Any

import numpy as np

from boa_tpu_torch.compute.xgb import load_pickled_ensembles
from boa_tpu_torch.device import named_device

logger = logging.getLogger(__name__)

PHASE_ORGANS = [
    "liver", "pancreas", "urinary_bladder", "gallbladder",
    "heart", "aorta", "inferior_vena_cava",
    "portal_vein_and_splenic_vein",
    "iliac_vena_left", "iliac_vena_right",
    "iliac_artery_left", "iliac_artery_right",
    "pulmonary_vein", "brain", "colon", "small_bowel",
]
PHASE_ORGANS_HN = [
    "internal_carotid_artery_right", "internal_carotid_artery_left",
    "internal_jugular_vein_right", "internal_jugular_vein_left",
]


def pi_time_to_phase(pi_time: float) -> tuple[str, float]:
    """Exact mapping of `totalseg_get_phase.py:23-55`."""
    if pi_time < 5:
        return "native", 1.0
    elif pi_time < 10:
        return "native", 0.7
    elif pi_time < 20:
        return "arterial_early", 0.7
    elif pi_time < 30:
        return "arterial_early", 1.0
    elif pi_time < 50:
        return "arterial_late", 1.0
    elif pi_time < 60:
        return "arterial_late", 0.7
    elif pi_time < 70:
        return "portal_venous", 1.0
    elif pi_time < 90:
        return "portal_venous", 1.0
    elif pi_time < 100:
        return "portal_venous", 0.7
    else:
        return "portal_venous", 0.3


def _heuristic_pi_time(features: dict[str, float]) -> float:
    """Estimate pi-time from aorta vs portal enhancement when no trained
    regressor is installed."""
    aorta = features.get("aorta", 0.0)
    portal = features.get("portal_vein_and_splenic_vein", 0.0)
    vci = features.get("inferior_vena_cava", 0.0)
    if aorta < 120:
        return 2.0
    if aorta - portal > 80:
        return 20.0  # arterial_early
    if aorta - portal > 30:
        return 40.0  # arterial_late
    if portal > 120 or vci > 110:
        return 75.0  # portal_venous
    return 100.0


def features_from_stats(stats: dict[str, Any],
                        stats_hn: dict[str, Any] | None = None
                        ) -> dict[str, float]:
    feats = {}
    for organ in PHASE_ORGANS:
        feats[organ] = float(stats.get(organ, {}).get("intensity", 0.0) or 0.0)
    hn = stats_hn or {}
    for organ in PHASE_ORGANS_HN:
        feats[organ] = float(hn.get(organ, {}).get("intensity", 0.0) or 0.0)
    return feats


_VENDORED_PHASE_PKL = (Path(__file__).resolve().parents[1] / "resources" /
                       "contrast_phase_classifiers_2024_07_19.pkl")


def _load_phase_ensemble(model_file: str | Path) -> list:
    """Fold regressors from a pickle: the reference's XGBoost pickle is
    decoded without xgboost via the UBJSON tree scorer; any other pickle
    is used through its sklearn-style .predict."""
    try:
        return list(load_pickled_ensembles(model_file).values())
    except Exception:
        with open(model_file, "rb") as f:
            clfs = pickle.load(f)
        return list(clfs.values() if isinstance(clfs, dict) else clfs)


def get_ct_contrast_phase(stats: dict[str, Any],
                          stats_hn: dict[str, Any] | None = None,
                          model_file: str | Path | None = None) -> dict:
    """stats: `get_basic_statistics` output of a `total` run (median HU)."""
    feats = features_from_stats(stats, stats_hn)
    vec = np.array([feats[o] for o in PHASE_ORGANS + PHASE_ORGANS_HN])
    model_file = model_file or os.environ.get("BOA_PHASE_MODEL")
    if model_file == "heuristic":  # explicit opt-out of any trained model
        model_file = None
    else:
        # the vendored folds ship with the package: a missing file (or a
        # typo'd path) must not silently degrade to the heuristic
        model_file = Path(model_file or _VENDORED_PHASE_PKL)
        if not model_file.exists():
            raise FileNotFoundError(f"phase model {model_file} not found")
    if model_file is not None:
        folds = _load_phase_ensemble(model_file)
        preds = np.array([float(np.asarray(clf.predict(vec[None]))[0])
                          for clf in folds])
        pi_time = round(float(preds.mean()), 2)
        pi_time_std = round(float(preds.std()), 4)
        pi_min, pi_max = (round(float(preds.min()), 2),
                          round(float(preds.max()), 2))
    else:
        pi_time = _heuristic_pi_time(feats)
        pi_time_std = 0.0
        pi_min = pi_max = pi_time
    phase, prob = pi_time_to_phase(pi_time)
    return {"pi_time": pi_time, "pi_time_std": pi_time_std,
            "phase": phase, "probability": prob,
            "pi_time_min": pi_min, "pi_time_max": pi_max}


def main(argv=None, *, store=None, fake_predict=None) -> None:
    """The command. `store` (default `ModelStore()`) and `fake_predict` (the
    pipeline's test hook) are for callers in Python, not on the command
    line."""
    from boa_tpu_torch.inference.pipeline import predict_image
    from boa_tpu_torch.io import nifti
    from boa_tpu_torch.weights.store import ModelStore

    ap = argparse.ArgumentParser("totalseg_get_phase")
    ap.add_argument("-i", "--input", type=Path, required=True)
    ap.add_argument("-o", "--output", type=Path, default=None)
    ap.add_argument("-m", "--model-file", type=Path, default=None)
    ap.add_argument("-d", "--device", default="gpu",
                    help="gpu (the card, default), gpu:N or cpu")
    args = ap.parse_args(argv)
    device = named_device(args.device)

    img = nifti.load(args.input)
    store = store or ModelStore()
    # the reference's feature semantics (`totalseg_get_phase.py:57-120`):
    # median HU, border masks included
    res = predict_image(img, "total", store, fast=True, statistics=True,
                        stats_aggregation="median", stats_exclude_border=False,
                        fake_predict=fake_predict, device=device)
    stats_hn = None
    if res.stats.get("brain", {}).get("volume", 0) > 100:
        # head present: the carotid/jugular features come from the
        # headneck_bones_vessels model (`:82-93`); without it they are 0
        res_hn = predict_image(img, "headneck_bones_vessels", store, statistics=True,
                               stats_aggregation="median", stats_exclude_border=False,
                               fake_predict=fake_predict, device=device)
        stats_hn = res_hn.stats
    out = get_ct_contrast_phase(res.stats, stats_hn, model_file=args.model_file)
    print(json.dumps(out, indent=2))
    if args.output:
        args.output.write_text(json.dumps(out, indent=2))


if __name__ == "__main__":
    main()
