"""Cross-configuration ensembling and postprocessing determination.

Counterpart of `boa_tpu/engine/ensembling.py`: nnU-Net's
`ensembling/ensemble.py:16-127` (`nnUNetv2_ensemble`: probabilities
averaged across prediction folders before the argmax),
`postprocessing/remove_connected_components.py:21-317` (keep the largest
component, first of the joint foreground, then per class, only where the
cross-validation Dice does not drop) and `find_best_configuration.py`.
Host numpy; connected components on scipy (`ops/connected_components.py`).

Run: `python -m boa_tpu_torch.engine.ensembling -i f1 f2 -o out`.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Sequence

import numpy as np

from boa_tpu_torch.engine.evaluation import evaluate_folder_arrays
from boa_tpu_torch.ops.connected_components import largest_component

logger = logging.getLogger(__name__)


def ensemble_probabilities(prob_list: Sequence[np.ndarray]) -> np.ndarray:
    """Mean of per-config (C, X, Y, Z) probability/logit volumes."""
    out = np.zeros_like(prob_list[0], dtype=np.float32)
    for p in prob_list:
        out += np.asarray(p, np.float32)
    return out / len(prob_list)


def ensemble_segmentations(prob_list: Sequence[np.ndarray]) -> np.ndarray:
    return np.argmax(ensemble_probabilities(prob_list), axis=0)


def remove_all_but_largest_component_from_segmentation(
        seg: np.ndarray, labels_or_regions, background: int = 0) -> np.ndarray:
    """`remove_connected_components.py:21-33` equivalent."""
    if not isinstance(labels_or_regions, (list, tuple)):
        labels_or_regions = [labels_or_regions]
    out = seg.copy()
    for lr in labels_or_regions:
        mask = np.isin(seg, np.asarray(lr)) if isinstance(lr, (list, tuple)) \
            else seg == lr
        if not mask.any():
            continue
        keep = largest_component(mask).astype(bool)
        out[mask & ~keep] = background
    return out


def determine_postprocessing(
        refs: dict[str, np.ndarray], preds: dict[str, np.ndarray],
        labels: Sequence[int], out_file: str | Path | None = None
) -> list[dict]:
    """Decide which largest-component filters help, by CV Dice.

    Mirrors `determine_postprocessing:52-246`: first test keeping only the
    largest joint-foreground component, then per-label filters; keep each
    step only if the mean foreground Dice does not get worse.
    """
    fg_labels = [lb for lb in labels if lb != 0]
    chosen: list[dict] = []
    cur = {k: v.copy() for k, v in preds.items()}
    base = evaluate_folder_arrays(refs, cur, fg_labels)["foreground_mean"]

    joint = {k: remove_all_but_largest_component_from_segmentation(
        v, [list(fg_labels)]) for k, v in cur.items()}
    res = evaluate_folder_arrays(refs, joint, fg_labels)
    if res["foreground_mean"].get("Dice", 0) >= base.get("Dice", 0):
        cur = joint
        chosen.append({"fn": "remove_all_but_largest_component",
                       "kwargs": {"labels_or_regions": [list(fg_labels)]}})
    else:
        res = evaluate_folder_arrays(refs, cur, fg_labels)

    # per-label filters only alter their own label's mask (removed voxels
    # become background), so only that label's per-case Dice column needs
    # re-evaluating — O(L) full-volume work instead of O(L^2)
    col_mean = {lb: float(np.nanmean(
        [res["metric_per_case"][c][str(lb)]["Dice"] for c in cur]))
        for lb in fg_labels}
    for lb in fg_labels:
        new_dice = []
        new_masks = {}
        for c, v in cur.items():
            mask = v == lb
            keep = largest_component(mask).astype(bool) if mask.any() else mask
            new_masks[c] = (mask, keep)
            mr = refs[c] == lb
            tp = int(np.sum(mr & keep))
            denom = 2 * tp + int(np.sum(~mr & keep)) + int(np.sum(mr & ~keep))
            new_dice.append(2 * tp / denom if denom else float("nan"))
        old_fg = float(np.nanmean(list(col_mean.values())))
        cand_cols = dict(col_mean)
        cand_cols[lb] = float(np.nanmean(new_dice))
        if float(np.nanmean(list(cand_cols.values()))) > old_fg:
            for c, (mask, keep) in new_masks.items():
                cur[c][mask & ~keep] = 0
            col_mean[lb] = cand_cols[lb]
            chosen.append({"fn": "remove_all_but_largest_component",
                           "kwargs": {"labels_or_regions": lb}})
    if out_file:
        Path(out_file).write_text(json.dumps(chosen, indent=2))
    return chosen


def apply_postprocessing(seg: np.ndarray, pp_fns: list[dict]) -> np.ndarray:
    for step in pp_fns:
        assert step["fn"] == "remove_all_but_largest_component"
        seg = remove_all_but_largest_component_from_segmentation(
            seg, **step["kwargs"])
    return seg


def find_best_configuration(
        refs: dict[str, np.ndarray],
        preds_per_config: dict[str, dict[str, np.ndarray]],
        labels: Sequence[int],
        allow_ensembling: bool = True,
        probs_per_config: dict[str, dict[str, np.ndarray]] | None = None
        ) -> dict:
    """Pick the best single configuration or 2-config ensemble by CV Dice,
    then determine postprocessing for the winner.

    Parity: `nnunetv2/evaluation/find_best_configuration.py` — evaluates
    each configuration (and pairwise probability ensembles when enabled)
    on cross-validation predictions, selects by mean foreground Dice, and
    attaches the postprocessing decision. Like nnU-Net, ensembling needs
    the predicted PROBABILITIES (`probs_per_config[name][case] ->
    (C, x, y, z)`); with hard labels only, two members cannot outvote
    each other, so ensemble candidates are skipped with a log line
    rather than scored as a fake copy of one member.
    """
    fg = [lb for lb in labels if lb != 0]
    scores: dict[str, float] = {}
    seg_sources: dict[str, dict[str, np.ndarray]] = {}
    for name, preds in preds_per_config.items():
        scores[name] = evaluate_folder_arrays(refs, preds, fg)[
            "foreground_mean"]["Dice"]
        seg_sources[name] = preds
    if allow_ensembling and len(preds_per_config) > 1:
        names = sorted(preds_per_config)
        have_probs = {n for n in names
                      if probs_per_config and set(probs_per_config.get(n, {}))
                      >= set(refs)}
        for i in range(len(names)):
            for j in range(i + 1, len(names)):
                a, b = names[i], names[j]
                if a not in have_probs or b not in have_probs:
                    logger.info(
                        "skipping ensemble %s+%s: probabilities unavailable "
                        "(predict with --save_probabilities)", a, b)
                    continue
                merged = {}
                for cid in refs:
                    ens = ensemble_probabilities(
                        [probs_per_config[a][cid].astype(np.float32),
                         probs_per_config[b][cid].astype(np.float32)])
                    merged[cid] = np.argmax(ens, axis=0).astype(
                        np.uint8 if ens.shape[0] <= 256 else np.uint16)
                key = f"ensemble___{a}___{b}"
                scores[key] = evaluate_folder_arrays(refs, merged, fg)[
                    "foreground_mean"]["Dice"]
                seg_sources[key] = merged
    best = max(scores, key=scores.get)
    pp = determine_postprocessing(refs, seg_sources[best], labels)
    return {"best_configuration": best, "scores": scores,
            "postprocessing": pp}


def ensemble_folders(folders, out_dir, save_probabilities: bool = False,
                     pp_file=None) -> list:
    """Average per-case `.npz` probabilities across prediction folders and
    write argmax segmentations — the `nnUNetv2_ensemble` entry
    (`nnunetv2/ensembling/ensemble.py:16-127`). Cases must have been
    predicted with `--save_probabilities`. `pp_file` optionally applies a
    postprocessing plan json (`nnUNetv2_apply_postprocessing`)."""
    import pickle

    from boa_tpu_torch.io import nifti, npz

    folders = [Path(f) for f in folders]
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    pp_fns = json.loads(Path(pp_file).read_text()) if pp_file else None
    case_sets = [{p.name[:-4] for p in f.glob("*.npz")} for f in folders]
    cases = sorted(set.intersection(*case_sets)) if case_sets else []
    missing = sorted(set.union(*case_sets) - set(cases)) if case_sets else []
    if missing:
        logger.warning("skipping %d cases missing from some folders: %s",
                       len(missing), missing[:5])
    written = []
    for cid in cases:
        probs = [np.load(f / f"{cid}.npz")["probabilities"].astype(np.float32)
                 for f in folders]
        ens = ensemble_probabilities(probs)
        seg = np.argmax(ens, axis=0).astype(
            np.uint8 if ens.shape[0] <= 256 else np.uint16)
        if pp_fns:
            seg = apply_postprocessing(seg, pp_fns)
        affine = None
        for f in folders:  # reuse the prediction's geometry when present
            cand = f / f"{cid}.nii.gz"
            if cand.exists():
                affine = nifti.load(cand).affine.copy()
                break
        if affine is None:
            with open(folders[0] / f"{cid}.pkl", "rb") as fh:
                props = pickle.load(fh)
            sp = list(props.get("spacing", (1.0, 1.0, 1.0)))[::-1]
            affine = np.diag(list(sp) + [1.0])
        out_f = out_dir / f"{cid}.nii.gz"
        nifti.save(nifti.NiftiImage(data=seg, affine=affine), out_f)
        if save_probabilities:
            npz.savez_compressed(out_dir / f"{cid}.npz",
                                probabilities=ens.astype(np.float16))
        written.append(out_f)
    return written


def main(argv=None) -> None:
    """CLI: `python -m boa_tpu_torch.engine.ensembling -i f1 f2 -o out`."""
    import argparse

    p = argparse.ArgumentParser(
        description="Ensemble prediction folders (nnUNetv2_ensemble "
                    "equivalent); requires .npz probability exports.")
    p.add_argument("-i", dest="folders", nargs="+", required=True)
    p.add_argument("-o", dest="output", required=True)
    p.add_argument("--save_npz", action="store_true", default=False,
                   help="also save the ensembled probabilities")
    p.add_argument("-pp", dest="pp_file", default=None,
                   help="postprocessing plan json (from "
                        "determine_postprocessing) to apply "
                        "(nnUNetv2_apply_postprocessing equivalent)")
    args = p.parse_args(argv)
    written = ensemble_folders(args.folders, args.output,
                               save_probabilities=args.save_npz,
                               pp_file=args.pp_file)
    print(f"ensembled {len(written)} cases -> {args.output}")



def find_best_configuration_folders(ref_dir, config_dirs: dict,
                                    out_file=None,
                                    allow_ensembling: bool = True) -> dict:
    """`nnUNetv2_find_best_configuration` over prediction folders: evaluate
    each configuration's cross-validation predictions against the
    references, try pairwise ensembles, pick by mean foreground Dice, and
    attach the postprocessing decision (find_best_configuration.py)."""
    from boa_tpu_torch.io import nifti

    ref_dir = Path(ref_dir)
    refs = {p.name[:-7]: np.asarray(nifti.load(p).data)
            for p in sorted(ref_dir.glob("*.nii.gz"))}
    preds_per_config = {}
    probs_per_config: dict[str, dict[str, np.ndarray]] = {}
    for name, d in config_dirs.items():
        d = Path(d)
        preds = {}
        probs = {}
        for cid in refs:
            f = d / f"{cid}.nii.gz"
            if f.exists():
                preds[cid] = np.asarray(nifti.load(f).data)
            npz = d / f"{cid}.npz"
            if npz.exists():  # --save_probabilities output: enables ensembles
                probs[cid] = np.load(npz)["probabilities"]
        if set(preds) != set(refs):
            missing = sorted(set(refs) - set(preds))
            raise FileNotFoundError(
                f"configuration {name!r} is missing predictions for "
                f"{missing[:5]}{'...' if len(missing) > 5 else ''}")
        preds_per_config[name] = preds
        probs_per_config[name] = probs
    labels = sorted({int(v) for s in refs.values()
                     for v in np.unique(s) if v != 0})
    result = find_best_configuration(refs, preds_per_config, [0] + labels,
                                     allow_ensembling=allow_ensembling,
                                     probs_per_config=probs_per_config)
    if out_file:
        Path(out_file).write_text(json.dumps(result, indent=2, default=str))
    return result


if __name__ == "__main__":
    main()
