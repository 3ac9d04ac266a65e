"""Segmentation evaluation: per-class/region Dice, IoU, TP/FP/FN/TN.

Counterpart of `boa_tpu/engine/evaluation.py` (nnU-Net's
`evaluate_predictions.py`, `nnUNetv2_evaluate_folder`): per-case per-label
metrics and a `foreground_mean` summary, written to a json, with
overlapping regions (a label may be a tuple of ints). Host numpy; integer
labels are counted in one pass of bincounts (the reference takes one pass
over the volume per label: 40 s for 117 labels on 10.5 M voxels on the
card machine's host), regions label by label.

Run: `python -m boa_tpu_torch.engine.evaluation ref/ pred/ -o summary.json`.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Sequence

import numpy as np


def _region_mask(seg: np.ndarray, label_or_region) -> np.ndarray:
    if isinstance(label_or_region, (tuple, list)):
        return np.isin(seg, np.asarray(label_or_region))
    return seg == label_or_region


def compute_tp_fp_fn_tn(mask_ref: np.ndarray, mask_pred: np.ndarray,
                        ignore_mask: np.ndarray | None = None):
    if ignore_mask is not None:
        use = ~ignore_mask
        mask_ref, mask_pred = mask_ref & use, mask_pred & use
        n = int(use.sum())
    else:
        n = mask_ref.size
    tp = int(np.sum(mask_ref & mask_pred))
    fp = int(np.sum(~mask_ref & mask_pred))
    fn = int(np.sum(mask_ref & ~mask_pred))
    tn = n - tp - fp - fn
    return tp, fp, fn, tn


def _label_counts(seg_ref: np.ndarray, seg_pred: np.ndarray, labels,
                  ignore: np.ndarray | None):
    """{label: (tp, fp, fn, tn)} for integer labels from one pass of
    bincounts, the counts `compute_tp_fp_fn_tn` gives label by label; None
    when a label is a region or a volume is not of non-negative integers."""
    if any(isinstance(lb, (tuple, list)) for lb in labels) or not all(
            np.issubdtype(a.dtype, np.integer) for a in (seg_ref, seg_pred)):
        return None
    r, p = seg_ref.ravel(), seg_pred.ravel()
    if ignore is not None:
        keep = ~ignore.ravel()
        r, p = r[keep], p[keep]
    if r.size and min(int(r.min()), int(p.min())) < 0:
        return None
    k = max([int(r.max(initial=0)), int(p.max(initial=0))] + [int(lb) for lb in labels]) + 1
    n_ref = np.bincount(r, minlength=k)
    n_pred = np.bincount(p, minlength=k)
    tps = np.bincount(r[r == p], minlength=k)
    out = {}
    for lb in labels:
        tp = int(tps[lb])
        fp, fn = int(n_pred[lb]) - tp, int(n_ref[lb]) - tp
        out[lb] = (tp, fp, fn, r.size - tp - fp - fn)
    return out


def evaluate_case(seg_ref: np.ndarray, seg_pred: np.ndarray,
                  labels: Sequence, ignore_label: int | None = None) -> dict:
    ignore = seg_ref == ignore_label if ignore_label is not None else None
    counts = _label_counts(np.asarray(seg_ref), np.asarray(seg_pred), labels, ignore)
    out = {}
    for lb in labels:
        if counts is not None:
            tp, fp, fn, tn = counts[lb]
        else:
            tp, fp, fn, tn = compute_tp_fp_fn_tn(_region_mask(seg_ref, lb),
                                                 _region_mask(seg_pred, lb), ignore)
        denom = 2 * tp + fp + fn
        out[str(lb)] = {
            "Dice": 2 * tp / denom if denom else float("nan"),
            "IoU": tp / (tp + fp + fn) if (tp + fp + fn) else float("nan"),
            "TP": tp, "FP": fp, "FN": fn, "TN": tn,
            "n_ref": tp + fn, "n_pred": tp + fp,
        }
    return out


def evaluate_folder_arrays(refs: dict[str, np.ndarray],
                           preds: dict[str, np.ndarray],
                           labels: Sequence,
                           ignore_label: int | None = None,
                           out_file: str | Path | None = None) -> dict:
    """{case_id: seg} pairs → per-case metrics + mean + foreground_mean."""
    per_case = {}
    for cid in sorted(refs):
        per_case[cid] = evaluate_case(refs[cid], preds[cid], labels,
                                      ignore_label)
    mean: dict[str, dict] = {}
    for lb in labels:
        key = str(lb)
        mean[key] = {
            m: float(np.nanmean([per_case[c][key][m] for c in per_case]))
            for m in ("Dice", "IoU")
        }
    fg = [mean[str(lb)]["Dice"] for lb in labels if str(lb) != "0"]
    result = {
        "metric_per_case": per_case,
        "mean": mean,
        "foreground_mean": {"Dice": float(np.nanmean(fg))} if fg else {},
    }
    if out_file:
        Path(out_file).write_text(json.dumps(result, indent=2))
    return result


def evaluate_folders(ref_dir, pred_dir, labels=None, out_file=None,
                     ignore_label=None) -> dict:
    """Evaluate `{case}.nii.gz` predictions against references — the
    `nnUNetv2_evaluate_folder` entry (`evaluation/evaluate_predictions.py`).
    Labels default to the union of nonzero labels in the references."""
    from boa_tpu_torch.io import nifti

    ref_dir, pred_dir = Path(ref_dir), Path(pred_dir)
    refs, preds = {}, {}
    missing = []
    for rp in sorted(ref_dir.glob("*.nii.gz")):
        cid = rp.name[:-7]
        pp = pred_dir / rp.name
        if not pp.exists():
            missing.append(cid)
            continue
        refs[cid] = np.asarray(nifti.load(rp).data)
        preds[cid] = np.asarray(nifti.load(pp).data)
    if missing:
        # nnUNetv2_evaluate_folder errors here too — silently scoring the
        # surviving subset makes a half-crashed prediction run look good
        raise FileNotFoundError(
            f"{pred_dir} is missing predictions for {len(missing)} reference "
            f"cases: {missing[:5]}{'...' if len(missing) > 5 else ''}")
    if not refs:
        raise FileNotFoundError(f"no matching case pairs between {ref_dir} "
                                f"and {pred_dir}")
    if labels is None:
        labels = sorted({int(v) for seg in refs.values()
                         for v in np.unique(seg) if v != 0})
    return evaluate_folder_arrays(refs, preds, labels,
                                  ignore_label=ignore_label,
                                  out_file=out_file)


def main(argv=None) -> None:
    """CLI: `python -m boa_tpu_torch.engine.evaluation ref/ pred/ -o summary.json`."""
    import argparse

    p = argparse.ArgumentParser(
        description="Evaluate predictions against reference segmentations "
                    "(nnUNetv2_evaluate_folder equivalent).")
    p.add_argument("ref_dir")
    p.add_argument("pred_dir")
    p.add_argument("-o", dest="out_file", default=None,
                   help="write the full summary json here")
    p.add_argument("-l", dest="labels", nargs="+", type=int, default=None)
    p.add_argument("--ignore_label", type=int, default=None)
    args = p.parse_args(argv)
    res = evaluate_folders(args.ref_dir, args.pred_dir, labels=args.labels,
                           out_file=args.out_file,
                           ignore_label=args.ignore_label)
    fg = res.get("foreground_mean", {}).get("Dice")
    print(f"cases: {len(res['metric_per_case'])}  "
          f"foreground mean Dice: {fg}")


if __name__ == "__main__":
    main()
