"""IV and GIT contrast prediction from organ HU features.

Counterpart of `boa_tpu/compute/contrast.py` (the `boa_contrast.predict`
call at body_organ_analysis `commands.py:216-241`): per-organ HU
statistics of the `total` labels, read from `total-measurements.json` (or
computed from the files when it is missing), give
- with a trained sklearn bundle (an explicit path or `BOA_CONTRAST_MODEL`
  that exists, else ``~/.boa_tpu/contrast_model.pkl`` if it exists): both
  answers from the bundle's `phase_models` and `git_models`
  (`predict_proba`, averaged). `pickle.load` imports sklearn, so a bundle
  needs sklearn where it is read, and a pickle is trusted code;
  `fit_contrast_model` writes one;
- otherwise the IV phase from the vendored pi-time regressor folds
  (`tools/get_phase.py`) through the organ median HUs, or the aorta/portal
  rule when no measurements exist, and GIT contrast from the vendored
  stand-in folds (`boa_tpu_torch/resources/git_contrast_classifiers_boa_tpu.json.*`,
  trained on synthetic phantoms by `compute/gbm.py`) through
  `compute/xgb.py`. `BOA_GIT_MODEL` names another fold stem, or
  ``heuristic`` for the bowel-HU rule.
A path that does not exist is ignored, as the reference ignores it.
"""

from __future__ import annotations

import json
import logging
import os
import pickle
from pathlib import Path
from typing import Any

import numpy as np

from boa_tpu_torch.compute.xgb import load_fold_files
from boa_tpu_torch.io import nifti
from boa_tpu_torch.tasks import class_maps
from boa_tpu_torch.tools.get_phase import PHASE_ORGANS, get_ct_contrast_phase
from boa_tpu_torch.utils.misc import create_mask

logger = logging.getLogger(__name__)

# organs whose HU statistics carry the contrast signal (vascular,
# parenchymal, excretory and GI compartments)
FEATURE_ORGANS = [
    "aorta", "inferior_vena_cava", "portal_vein_and_splenic_vein",
    "heart", "pulmonary_vein",
    "liver", "spleen", "pancreas",
    "kidney_left", "kidney_right",
    "urinary_bladder",
    "stomach", "duodenum", "small_bowel", "colon",
]
FEATURE_STATS = ["mean", "std", "median", "q25", "q75"]

PHASES = ["native", "arterial", "portal_venous"]


def extract_features(ct_data: np.ndarray, total_seg: np.ndarray) -> dict[str, float]:
    """Per-organ HU statistics; NaN for absent organs."""
    inv = {v: k for k, v in class_maps.get_class_map("total").items()}
    feats: dict[str, float] = {}
    for organ in FEATURE_ORGANS:
        label = inv.get(organ)
        vals = ct_data[create_mask(total_seg, label)] if label is not None else np.empty(0)
        if vals.size == 0:
            for s in FEATURE_STATS:
                feats[f"{organ}_{s}"] = float("nan")
            continue
        vals = vals.astype(np.float32)
        q25, med, q75 = np.percentile(vals, [25, 50, 75])
        feats[f"{organ}_mean"] = float(vals.mean())
        feats[f"{organ}_std"] = float(vals.std())
        feats[f"{organ}_median"] = float(med)
        feats[f"{organ}_q25"] = float(q25)
        feats[f"{organ}_q75"] = float(q75)
    return feats


def feature_vector(feats: dict[str, float]) -> np.ndarray:
    return np.array([feats[f"{o}_{s}"] for o in FEATURE_ORGANS for s in FEATURE_STATS],
                    dtype=np.float32)


def _model_path(explicit: str | Path | None = None) -> Path | None:
    """The bundle the reference would load: an explicit path or
    `BOA_CONTRAST_MODEL` that exists, else the home default if it exists."""
    p = explicit or os.environ.get("BOA_CONTRAST_MODEL")
    if p and Path(p).exists():
        return Path(p)
    default = Path.home() / ".boa_tpu" / "contrast_model.pkl"
    return default if default.exists() else None


def _heuristic_phase(feats: dict[str, float]) -> tuple[int, list[float]]:
    """Enhancement rules: native where the aorta is under 120 HU, arterial
    where it leads the portal system by more than 60 HU, else portal-venous."""
    aorta = feats.get("aorta_median", float("nan"))
    portal = feats.get("portal_vein_and_splenic_vein_median", float("nan"))
    if np.isnan(aorta):
        return 0, [1.0, 0.0, 0.0]
    if aorta < 120:
        return 0, [0.9, 0.05, 0.05]
    if not np.isnan(portal) and aorta - portal > 60:
        return 1, [0.05, 0.85, 0.10]
    return 2, [0.05, 0.15, 0.80]


def _heuristic_git(feats: dict[str, float]) -> tuple[int, float]:
    """Bowel-q75 sigmoid (`BOA_GIT_MODEL=heuristic`)."""
    # oral contrast pushes bowel contents far above water/soft tissue
    vals = [feats.get(f"{o}_q75", float("nan"))
            for o in ("stomach", "duodenum", "small_bowel", "colon")]
    vals = [v for v in vals if not np.isnan(v)]
    score = max(vals) if vals else float("nan")
    if np.isnan(score):
        return 0, 0.0
    prob = float(1.0 / (1.0 + np.exp(-(score - 150.0) / 30.0)))
    return int(prob > 0.5), prob


_VENDORED_GIT_FOLDS = (Path(__file__).resolve().parents[1] / "resources" /
                       "git_contrast_classifiers_boa_tpu.json")


def _git_ensemble():
    """The GIT fold models, or None for `BOA_GIT_MODEL=heuristic`.

    BOA_GIT_MODEL: fold-file stem of another model (`<stem>.0..4`, xgboost
    JSON/UBJSON over the `feature_vector` layout); the vendored stem by
    default, which ships with the package."""
    env = os.environ.get("BOA_GIT_MODEL")
    if env == "heuristic":
        return None
    stem = Path(env) if env else _VENDORED_GIT_FOLDS
    if not Path(f"{stem}.0").exists():
        raise FileNotFoundError(f"BOA_GIT_MODEL={env or ''}: no {stem}.0")
    return load_fold_files(stem)


def _git_from_features(feats: dict[str, float]) -> tuple[int, float]:
    """GIT presence from the fold ensemble (mean fold probability); NaN
    features follow the trees' learned default directions."""
    folds = _git_ensemble()
    if folds is None:
        logger.info("BOA_GIT_MODEL=heuristic: using the heuristic GIT rule")
        return _heuristic_git(feats)
    x = feature_vector(feats)[None]
    prob = float(np.mean([f.predict(x)[0] for f in folds]))
    return int(prob > 0.5), prob


_STAT_FROM_JSON = {"mean": "mean_hu", "std": "std_hu", "median": "median_hu",
                   "q25": "25th_percentile_hu", "q75": "75th_percentile_hu"}


def features_from_measurements(measurements: dict[str, Any]) -> dict[str, float] | None:
    """Contrast features straight from total-measurements.json, whose
    per-region statistics hold each organ's mean, std, median and
    quartiles."""
    regions = measurements.get("segmentations", {}).get("total")
    if not regions:
        return None
    feats: dict[str, float] = {}
    for organ in FEATURE_ORGANS:
        entry = regions.get(organ) or {}
        present = entry.get("present", False)
        for stat, json_key in _STAT_FROM_JSON.items():
            feats[f"{organ}_{stat}"] = float(entry[json_key]) if present else float("nan")
    return feats


def _phase_from_pi_time(measurements: dict[str, Any] | None
                        ) -> tuple[int, list[float]] | None:
    """IV phase via the vendored pi-time regressors, from the organ median
    HUs of the measurements JSON; None without measurements. The four
    head/neck vessel features stay zero (the regressor's brain-absent
    convention): BOA runs no headneck model."""
    if measurements is None:
        return None
    regions = measurements.get("segmentations", {}).get("total") or {}
    stats: dict[str, dict[str, float]] = {}
    for organ in PHASE_ORGANS:
        entry = regions.get(organ) or {}
        stats[organ] = {"intensity": float(entry.get("median_hu") or 0.0)
                        if entry.get("present") else 0.0}
    try:
        res = get_ct_contrast_phase(stats)
    except Exception:
        logger.exception("pi-time phase prediction failed")
        return None
    name = {"native": "native", "arterial_early": "arterial",
            "arterial_late": "arterial", "portal_venous": "portal_venous"}[res["phase"]]
    idx = PHASES.index(name)
    probs = [0.0, 0.0, 0.0]
    probs[idx] = float(res["probability"])
    rest = (1.0 - probs[idx]) / 2
    probs = [p if i == idx else rest for i, p in enumerate(probs)]
    return idx, probs


def predict(ct_path: Path | str | nifti.NiftiImage,
            segmentation_folder: Path | str,
            model_path: str | Path | None = None,
            one_mask_per_file: bool = False) -> dict[str, Any]:
    """`boa_contrast.predict`-compatible entry."""
    measurements = None
    meas_path = Path(segmentation_folder) / "total-measurements.json"
    if meas_path.exists():
        with meas_path.open() as fh:
            measurements = json.load(fh)
    feats = features_from_measurements(measurements) if measurements else None
    if feats is None:  # no measurements on disk: one pass over the files
        ct_img = ct_path if isinstance(ct_path, nifti.NiftiImage) else nifti.load(Path(ct_path))
        total = nifti.load(Path(segmentation_folder) / "total.nii.gz")
        feats = extract_features(np.asarray(ct_img.data), np.asarray(total.data))

    mp = _model_path(model_path)
    if mp is not None:
        with open(mp, "rb") as f:
            bundle = pickle.load(f)
        x = np.nan_to_num(feature_vector(feats), nan=-1024.0)[None]
        phase_probs = np.mean([m.predict_proba(x)[0] for m in bundle["phase_models"]], axis=0)
        git_probs = np.mean([m.predict_proba(x)[0] for m in bundle["git_models"]], axis=0)
        phase_idx = int(np.argmax(phase_probs))
        git_idx = int(np.argmax(git_probs))
        git_prob = float(git_probs[1]) if len(git_probs) > 1 else 0.0
    else:
        pi_phase = _phase_from_pi_time(measurements)
        if pi_phase is None:
            logger.info("No measurements for the pi-time phase; using the heuristic rules")
            pi_phase = _heuristic_phase(feats)
        phase_idx = pi_phase[0]
        try:
            git_idx, git_prob = _git_from_features(feats)
        except FileNotFoundError:
            # a typo'd BOA_GIT_MODEL must not take the IV phase down with it
            # (analyze_ct's contrast guard would drop both info rows)
            logger.exception("BOA_GIT_MODEL is set but unloadable; falling back to the "
                             "heuristic GIT rule for this study")
            git_idx, git_prob = _heuristic_git(feats)

    return {
        "phase_ensemble_predicted_class": PHASES[phase_idx],
        "phase_ensemble_prediction": phase_idx,
        "git_ensemble_predicted_class": bool(git_idx),
        "git_ensemble_prediction": git_prob,
        # True unless a trained bundle answered: the GIT folds are a
        # synthetic-phantom stand-in, and the info sheet says so
        "git_classifier_is_standin": mp is None,
        "features": feats,
    }


def fit_contrast_model(features: np.ndarray, phase_labels: np.ndarray,
                       git_labels: np.ndarray, n_ensemble: int = 5,
                       out_path: str | Path | None = None) -> dict:
    """Train a fresh sklearn GBM ensemble (per-study `feature_vector` rows)
    and pickle it to `out_path` when given; sklearn is imported here only."""
    from sklearn.ensemble import HistGradientBoostingClassifier

    x = np.nan_to_num(np.asarray(features, np.float32), nan=-1024.0)
    bundle = {"phase_models": [], "git_models": [],
              "feature_names": [f"{o}_{s}" for o in FEATURE_ORGANS for s in FEATURE_STATS]}
    for i in range(n_ensemble):
        pm = HistGradientBoostingClassifier(random_state=i)
        pm.fit(x, phase_labels)
        bundle["phase_models"].append(pm)
        gm = HistGradientBoostingClassifier(random_state=100 + i)
        gm.fit(x, git_labels)
        bundle["git_models"].append(gm)
    if out_path:
        Path(out_path).parent.mkdir(parents=True, exist_ok=True)
        with open(out_path, "wb") as f:
            pickle.dump(bundle, f)
    return bundle
