"""Folder-level prediction with a trained model: `nnUNetv2_predict`.

Counterpart of `boa_tpu/engine/predict.py` (nnU-Net's
`predict_from_raw_data.py:776-1018`). Every case of a folder is predicted
with a model taken either from the weights store (`-d` dataset id, `-tr`
trainer, `-c` configuration) or from an explicit model folder (`-m`, with
`fold_X` subfolders holding `checkpoint_final.npz`, or nnU-Net's
`checkpoint_final.pth`, converted at first use and cached as `.npz`; a
`.pth` is trusted code, see `weights/convert.py`). Options: folds,
sliding-window step, mirror TTA off, probabilities (`{case}.npz` +
`{case}.pkl`, nnU-Net's pair), `--continue_prediction` (skip cases already
written), `-num_parts` / `-part_id` (each part takes
`cases[part_id::num_parts]`), `-chk`, and the cascade: a configuration
with a previous stage predicts that stage first, from the sibling
``...__<previous configuration>`` model folder, into
`out/segs_from_prev_stage_<conf>/`, unless `-prev_stage_predictions`
names a folder. Mirror axes come from the trainer's variant
(`train/variants.py`).

Run on the card (`-device gpu`, the default; `cuda`, `gpu:N`; `cpu` the
host):

    python -m boa_tpu_torch.engine.predict -i cases/ -o preds/ -m <model folder> -f 0 1
    python -m boa_tpu_torch.engine.predict -i cases/ -o preds/ -d 297 -c 3d_fullres -f 0
"""

from __future__ import annotations

import argparse
import json
import logging
from pathlib import Path

import numpy as np

from boa_tpu_torch.io import nifti
from boa_tpu_torch.plans.plans import ModelPlans

logger = logging.getLogger(__name__)


def list_cases(in_dir: Path) -> list[tuple[str, list[Path]]]:
    """(case_id, channel files) pairs; accepts nnU-Net `{case}_0000.nii.gz`
    channel naming (sorted by channel index) and plain `{case}.nii.gz`.

    A `_NNNN` suffix only counts as a channel index when the group starts
    at `_0000` with consecutive indices (the nnU-Net convention), so plain
    series numbered `study_0001..study_0020` stay twenty cases."""
    groups: dict[str, list[tuple[int, Path]]] = {}
    plain: dict[str, list[Path]] = {}
    for p in sorted(Path(in_dir).iterdir()):
        name = p.name
        if not (name.endswith(".nii.gz") or name.endswith(".nii")):
            continue
        stem = name[:-7] if name.endswith(".nii.gz") else name[:-4]
        if len(stem) > 5 and stem[-5] == "_" and stem[-4:].isdigit():
            groups.setdefault(stem[:-5], []).append((int(stem[-4:]), p))
        else:
            plain.setdefault(stem, []).append(p)
    cases: dict[str, list[Path]] = dict(plain)
    for cid, chans in groups.items():
        chans.sort()
        if [c for c, _ in chans] == list(range(len(chans))):
            cases.setdefault(cid, []).extend(p for _, p in chans)
        else:  # not 0000..000k: separate plain-named cases
            for idx, p in chans:
                cases.setdefault(f"{cid}_{idx:04d}", []).append(p)
    return sorted(cases.items())


def load_model_folder(mdir: Path, folds, chk: str = "checkpoint_final",
                      configuration: str = "3d_fullres"
                      ) -> tuple[ModelPlans, list[dict]]:
    """(plans, [numpy parameter pytree per fold]) of an nnU-Net-layout model
    folder; `folds=None` takes every `fold_*`. An unknown configuration
    raises ValueError (as nnUNetv2_predict)."""
    from boa_tpu_torch.weights.store import load_fold

    mdir = Path(mdir)
    known = json.loads((mdir / "plans.json").read_text())["configurations"]
    if configuration not in known:
        raise ValueError(f"configuration {configuration!r} not in plans.json "
                         f"(available: {sorted(known)})")
    plans = ModelPlans.from_model_folder(mdir, configuration=configuration)
    cfg = plans.arch_config()
    if folds is None:
        folds = sorted(int(p.name.split("_")[1]) for p in mdir.glob("fold_*"))
    return plans, [load_fold(mdir / f"fold_{f}", cfg, chk) for f in folds]


def _load_case(files: list[Path], cid: str):
    """(image of the first file, (X, Y, Z) or (C, X, Y, Z) data)."""
    def load_3d(path):
        arr = np.asarray(nifti.load(path).data)
        return arr[..., 0] if arr.ndim == 4 and arr.shape[-1] == 1 else arr

    img = nifti.load(files[0])
    data = np.asarray(img.data)
    if len(files) > 1:  # one file per channel: (C, X, Y, Z)
        chans = [load_3d(f) for f in files]
        bad = [f.name for f, a in zip(files, chans) if a.ndim != 3]
        if bad:
            raise ValueError(f"case {cid}: multi-file channels must be 3D "
                             f"volumes; got 4D in {bad}")
        data = np.stack(chans)
    elif data.ndim == 4:
        data = data[..., 0] if data.shape[-1] == 1 else np.moveaxis(data, -1, 0)
    return img, data


def predict_folder(
    in_dir: Path, out_dir: Path, *,
    model_dir: Path | None = None,
    task_id: int | None = None,
    trainer: str = "nnUNetTrainer",
    configuration: str = "3d_fullres",
    folds=None,
    step_size: float = 0.5,
    disable_tta: bool = False,
    save_probabilities: bool = False,
    continue_prediction: bool = False,
    num_parts: int = 1,
    part_id: int = 0,
    chk: str = "checkpoint_final",
    store=None,
    folder_with_segs_from_prev_stage: Path | None = None,
    device=None,
    spans: dict | None = None,
) -> list[Path]:
    """Predict every case in `in_dir` on `device` (default the card);
    returns the written segmentation paths.

    A cascade configuration (a plan with ``previous_stage``) reads each
    case's previous-stage labels `{case}.nii.gz` from
    `folder_with_segs_from_prev_stage`; without it, the previous stage of
    the same model is predicted first into
    `out_dir/segs_from_prev_stage_<conf>/` (for `-m`, from the sibling
    model folder, which must exist). `spans`, when given, gets the seconds
    of `load_weights` (conversion of `.pth` folds included), `predict` and
    `export` (the NIfTI and probability files), summed over the cases."""
    from boa_tpu_torch.device import resolve_device
    from boa_tpu_torch.inference.pipeline import _save_probabilities
    from boa_tpu_torch.inference.predictor import Predictor
    from boa_tpu_torch.train.variants import get_variant
    from boa_tpu_torch.utils.timing import Spans

    in_dir, out_dir = Path(in_dir), Path(out_dir)
    if not 0 <= part_id < num_parts:
        raise ValueError(f"part_id {part_id} not in [0, {num_parts})")
    device = resolve_device(device)
    sp = Spans(spans, device)
    if model_dir is None:
        if task_id is None:
            raise ValueError("need either model_dir (-m) or task_id (-d)")
        from boa_tpu_torch.weights.store import ModelStore

        store = store or ModelStore()
        mdir = store.model_dir(task_id, trainer, model=configuration)
    else:
        mdir = Path(model_dir)
    plans, fold_params = load_model_folder(mdir, folds, chk, configuration)
    sp.mark("load_weights")

    prev_dir = folder_with_segs_from_prev_stage
    if plans.previous_stage is not None and prev_dir is None:
        prev_conf = plans.previous_stage
        prev_model_dir = None
        if model_dir is not None:
            # the previous stage's weights live in the sibling
            # `...__<prev_conf>` folder; loading this folder's under the
            # other plan would be wrong, so a missing sibling raises
            cand = mdir.parent / mdir.name.replace(configuration, prev_conf)
            if cand == mdir or not cand.is_dir():
                raise FileNotFoundError(
                    f"cascade needs the previous stage {prev_conf!r}: expected "
                    f"the sibling model folder {cand}; predict that stage "
                    f"first or pass folder_with_segs_from_prev_stage")
            prev_model_dir = cand
        prev_dir = out_dir / f"segs_from_prev_stage_{prev_conf}"
        logger.info("cascade: predicting previous stage %r into %s",
                    prev_conf, prev_dir)
        predict_folder(
            in_dir, prev_dir, model_dir=prev_model_dir, task_id=task_id,
            trainer=trainer, configuration=prev_conf, folds=folds,
            step_size=step_size, disable_tta=disable_tta,
            continue_prediction=continue_prediction, num_parts=num_parts,
            part_id=part_id, chk=chk, store=store, device=device, spans=spans)
        sp.restart()
    if prev_dir is not None:
        prev_dir = Path(prev_dir)

    mirror_axes = () if disable_tta else get_variant(trainer).mirror_axes
    predictor = Predictor(plans=plans, fold_params=fold_params,
                          tile_step_size=step_size, mirror_axes=mirror_axes,
                          device=device)
    sp.mark("load_weights")

    cases = list_cases(in_dir)[part_id::num_parts]
    logger.info("predicting %d cases (part %d/%d)", len(cases), part_id, num_parts)
    out_dir.mkdir(parents=True, exist_ok=True)
    written = []
    for cid, files in cases:
        out_f = out_dir / f"{cid}.nii.gz"
        if continue_prediction and out_f.exists():
            logger.info("%s exists, skipping (continue_prediction)", cid)
            continue
        img, data = _load_case(files, cid)
        prev_seg = None
        if plans.previous_stage is not None:
            prev_f = prev_dir / f"{cid}.nii.gz"
            if not prev_f.exists():
                raise FileNotFoundError(f"cascade: no previous-stage "
                                        f"segmentation for case {cid} in {prev_dir}")
            prev_seg = np.asarray(nifti.load(prev_f).data)
        sp.restart()
        probs = None
        if save_probabilities:
            seg, probs = predictor.predict(data, img.zooms, return_probabilities=True,
                                           prev_seg_xyz=prev_seg)
        else:
            seg = predictor.predict(data, img.zooms, prev_seg_xyz=prev_seg)
        sp.mark("predict")
        if probs is not None:
            _save_probabilities(probs, out_dir / f"{cid}.npz", img.zooms)
        nifti.save(nifti.NiftiImage(data=np.asarray(seg), affine=img.affine.copy()),
                   out_f)
        sp.mark("export")
        written.append(out_f)
        logger.info("%s done (%s)", cid, seg.shape)
    return written


def main(argv=None) -> None:
    from boa_tpu_torch.device import named_device

    p = argparse.ArgumentParser(
        description="Predict a folder of cases with a trained model "
                    "(nnUNetv2_predict equivalent).")
    p.add_argument("-i", dest="input", type=Path, required=True,
                   help="input folder of .nii.gz cases (optionally with "
                        "nnU-Net _0000 channel suffixes)")
    p.add_argument("-o", dest="output", type=Path, required=True,
                   help="output folder for {case}.nii.gz predictions")
    p.add_argument("-d", dest="task_id", type=int, default=None,
                   help="dataset/task id in the weights store")
    p.add_argument("-m", dest="model_dir", type=Path, default=None,
                   help="explicit model folder (with fold_X subfolders); "
                        "alternative to -d")
    p.add_argument("-tr", dest="trainer", type=str, default="nnUNetTrainer")
    p.add_argument("-c", dest="configuration", type=str, default="3d_fullres")
    p.add_argument("-f", dest="folds", nargs="+", type=int, default=None,
                   help="folds to ensemble (default: all available)")
    p.add_argument("-step_size", type=float, default=0.5)
    p.add_argument("--disable_tta", action="store_true", default=False,
                   help="disable mirror test-time augmentation")
    p.add_argument("--save_probabilities", action="store_true", default=False)
    p.add_argument("--continue_prediction", "--c", action="store_true",
                   default=False, dest="continue_prediction")
    p.add_argument("-chk", type=str, default="checkpoint_final")
    p.add_argument("-npp", type=int, default=3,
                   help="accepted for parity (no preprocess workers here)")
    p.add_argument("-nps", type=int, default=3,
                   help="accepted for parity (no export workers here)")
    p.add_argument("-prev_stage_predictions", type=Path, default=None,
                   help="folder with previous-stage segmentations for "
                        "cascade configurations (default: predicted "
                        "automatically)")
    p.add_argument("-num_parts", type=int, default=1)
    p.add_argument("-part_id", type=int, default=0)
    p.add_argument("-device", type=str, default="gpu",
                   help="gpu (the default; also cuda, gpu:N) or cpu")
    p.add_argument("--verbose", action="store_true", default=False)
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.DEBUG if args.verbose else logging.INFO)
    predict_folder(
        args.input, args.output, model_dir=args.model_dir,
        task_id=args.task_id, trainer=args.trainer,
        configuration=args.configuration, folds=args.folds,
        step_size=args.step_size, disable_tta=args.disable_tta,
        save_probabilities=args.save_probabilities,
        continue_prediction=args.continue_prediction,
        num_parts=args.num_parts, part_id=args.part_id, chk=args.chk,
        folder_with_segs_from_prev_stage=args.prev_stage_predictions,
        device=named_device(args.device))


if __name__ == "__main__":
    main()
