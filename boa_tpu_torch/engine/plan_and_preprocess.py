"""Dataset workflow: a raw nnU-Net dataset -> fingerprint -> plans ->
preprocessed case store, with the resample on the card.

Counterpart of `boa_tpu/engine/plan_and_preprocess.py`
(`nnUNetv2_plan_and_preprocess`): reads `imagesTr/`, `labelsTr/` and
`dataset.json`, extracts the fingerprint, plans (`engine/planner.py`) and
preprocesses every case once — crop to the nonzero box and CT-normalize
on the host, then per configuration the order-3 resample of the data and
the nearest resample of the labels to the plan spacing on the device
(`ops/resample.py`, the reference's "resize" convention) — into a
`CaseStore` per configuration (`cases/` for 3d_fullres, `cases_<name>/`
otherwise) for `train/run_training.py`.

Usage:
    python -m boa_tpu_torch.engine.plan_and_preprocess DATASET_DIR OUT_DIR [-d cpu]
"""

from __future__ import annotations

import argparse
import json
import logging
from pathlib import Path

import numpy as np
import torch

from boa_tpu_torch.device import named_device

logger = logging.getLogger(__name__)


def _case_ids(dataset_dir: Path) -> list[str]:
    stems = []
    for p in (dataset_dir / "imagesTr").glob("*.nii*"):
        name = p.name
        for suffix in (".nii.gz", ".nii"):
            if name.endswith(suffix):
                name = name[: -len(suffix)]
        stems.append(name)
    # an _NNNN tail is the channel suffix only when the case's _0000 exists
    all_stems = set(stems)
    ids = set()
    for name in stems:
        if name[-5:-4] == "_" and name[-4:].isdigit() and f"{name[:-5]}_0000" in all_stems:
            name = name[:-5]
        ids.add(name)
    return sorted(ids)


def _load_case(dataset_dir: Path, cid: str):
    from boa_tpu_torch.io import nifti

    img_p = None
    for cand in (f"{cid}_0000.nii.gz", f"{cid}_0000.nii", f"{cid}.nii.gz", f"{cid}.nii"):
        if (dataset_dir / "imagesTr" / cand).exists():
            img_p = dataset_dir / "imagesTr" / cand
            break
    if img_p is None:
        raise FileNotFoundError(f"no image for case {cid}")
    img = nifti.load(img_p)
    seg = None
    for cand in (f"{cid}.nii.gz", f"{cid}.nii"):
        if (dataset_dir / "labelsTr" / cand).exists():
            seg = nifti.load(dataset_dir / "labelsTr" / cand)
            break
    return img, seg


def plan_and_preprocess(dataset_dir: str | Path, out_dir: str | Path,
                        hbm_target_gb: float = 8.0,
                        configurations: tuple = ("3d_fullres",),
                        device="gpu") -> dict:
    """Returns the plans; writes plans.json, fingerprint.json and one case
    store per requested configuration under `out_dir`. Configurations the
    planner did not emit, or that are not 3d, are skipped with a log line.
    `device`: "gpu" (default), "gpu:N" or "cpu"."""
    from boa_tpu_torch.engine.fingerprint import extract_fingerprint
    from boa_tpu_torch.engine.planner import plan_experiment
    from boa_tpu_torch.ops import preprocess as pp
    from boa_tpu_torch.ops import resample as rs
    from boa_tpu_torch.train.dataset import CaseStore

    dev = named_device(device)
    dataset_dir, out_dir = Path(dataset_dir), Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    dataset_json = json.loads((dataset_dir / "dataset.json").read_text())
    labels = dataset_json.get("labels", {})
    num_classes = len({int(v) for v in labels.values()
                       if not isinstance(v, (list, tuple))}) or 2
    ids = _case_ids(dataset_dir)
    if not ids:
        raise FileNotFoundError(f"no training cases in {dataset_dir}")
    logger.info("planning over %d cases", len(ids))

    def gen():
        for cid in ids:
            img, seg = _load_case(dataset_dir, cid)
            yield (np.asarray(img.data), np.asarray(seg.data) if seg is not None else None,
                   img.zooms)

    fingerprint = extract_fingerprint(gen(), out_file=out_dir / "fingerprint.json")
    plans = plan_experiment(fingerprint, num_classes, out_file=out_dir / "plans.json",
                            hbm_target_gb=hbm_target_gb)
    props = plans["foreground_intensity_properties_per_channel"]["0"]

    targets = []
    for config in configurations:
        if config not in plans["configurations"]:
            logger.info("configuration %r not planned for this dataset, skipping "
                        "its preprocessing", config)
            continue
        conf = dict(plans["configurations"][config])
        while conf.get("inherits_from"):
            base = dict(plans["configurations"][conf.pop("inherits_from")])
            base.update(conf)
            conf = base
        if "spacing" not in conf or len(conf["spacing"]) != 3:
            logger.info("configuration %r is not 3D, skipping", config)
            continue
        sub = "cases" if config == "3d_fullres" else f"cases_{config}"
        targets.append((config, np.asarray(conf["spacing"], np.float64),
                        CaseStore(out_dir / sub)))

    # each case is read, cropped and normalized once; only the resample runs
    # per configuration
    for cid in ids if targets else []:
        img, seg = _load_case(dataset_dir, cid)
        data = np.asarray(img.data, np.float32)
        segd = np.asarray(seg.data) if seg is not None else np.zeros(data.shape, np.int8)
        sl = tuple(slice(b[0], b[1]) for b in pp.nonzero_bbox(data))
        data, segd = data[sl], segd[sl]
        data = np.clip(data, props["percentile_00_5"], props["percentile_99_5"])
        data = (data - props["mean"]) / max(props["std"], 1e-8)
        cur = np.asarray(img.zooms, np.float64)
        data_dev = seg_dev = None
        for config, target, store in targets:
            new_shape = rs.compute_new_shape(data.shape, cur, target)
            d, s = data, segd
            if tuple(new_shape) != data.shape:
                if data_dev is None:
                    data_dev = torch.from_numpy(np.ascontiguousarray(data)).to(dev)
                    seg_dev = torch.from_numpy(np.ascontiguousarray(segd)).to(dev)
                d = rs.resample_volume(data_dev, tuple(new_shape), order=3,
                                       convention="resize").cpu().numpy()
                s = rs.resample_nearest(seg_dev, tuple(new_shape),
                                        convention="resize").cpu().numpy()
            store.save_case(cid, d, s)
            logger.info("preprocessed %s [%s] -> %s", cid, config, tuple(new_shape))
    return plans


def main(argv=None) -> None:
    ap = argparse.ArgumentParser("boa_tpu_torch-plan-and-preprocess")
    ap.add_argument("dataset_dir", type=Path)
    ap.add_argument("out_dir", type=Path)
    ap.add_argument("--hbm-gb", type=float, default=8.0)
    ap.add_argument("-c", "--configurations", nargs="+", default=["3d_fullres"],
                    help="configurations to preprocess case stores for "
                         "(e.g. 3d_fullres 3d_lowres for a cascade run)")
    ap.add_argument("-d", "--device", default="gpu",
                    help="gpu (default: the card), gpu:N, or cpu")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    plan_and_preprocess(args.dataset_dir, args.out_dir, args.hbm_gb,
                        configurations=tuple(args.configurations), device=args.device)


if __name__ == "__main__":
    main()
