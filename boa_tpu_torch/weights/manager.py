"""Weights manager: download / import / list / export / create-synthetic.

Counterpart of `boa_tpu/weights/manager.py` (TotalSegmentator's
`libs.py:66-540` download and unpack, BOA's BCA weight release): the same
release table and commands. `download` fetches a release zip with urllib,
refuses members that would land outside the store (zip-slip), unpacks it
and converts every fold's `checkpoint_final.pth` to `.npz` in place;
`import` converts a local nnU-Net results folder into the store; `export`
turns a training output (`train/run_training.py`) into a servable entry;
`create-synthetic` writes a random-weight model at a task's architecture.

Every command that writes a model checks it on the device: each fold is
loaded and built into the network there (`weights/convert.py:
params_from_numpy`), on the card unless `-d cpu`. `list` reads no weights.

Usage:
    python -m boa_tpu_torch.weights.manager list
    python -m boa_tpu_torch.weights.manager download total total_fast bca
    python -m boa_tpu_torch.weights.manager import /path/to/DatasetXXX_.../trainer__plans__conf
    python -m boa_tpu_torch.weights.manager export TRAINING_DIR --task-id 901 --name mine
    python -m boa_tpu_torch.weights.manager create-synthetic --task total_fast
"""

from __future__ import annotations

import argparse
import logging
import shutil
import tempfile
import urllib.request
import zipfile
from pathlib import Path

logger = logging.getLogger(__name__)

_TS_URL = "https://github.com/wasserth/TotalSegmentator/releases/download"
_BOA_URL = ("https://github.com/UMEssen/Body-and-Organ-Analysis/releases/"
            "download/v1.0.0-weights")

# task_id -> (folder name, download url); public v2.0.0 weight release
WEIGHT_URLS: dict[int, tuple[str, str]] = {
    291: ("Dataset291_TotalSegmentator_part1_organs_1559subj",
          f"{_TS_URL}/v2.0.0-weights/"
          f"Dataset291_TotalSegmentator_part1_organs_1559subj.zip"),
    292: ("Dataset292_TotalSegmentator_part2_vertebrae_1532subj",
          f"{_TS_URL}/v2.0.0-weights/"
          f"Dataset292_TotalSegmentator_part2_vertebrae_1532subj.zip"),
    293: ("Dataset293_TotalSegmentator_part3_cardiac_1559subj",
          f"{_TS_URL}/v2.0.0-weights/"
          f"Dataset293_TotalSegmentator_part3_cardiac_1559subj.zip"),
    294: ("Dataset294_TotalSegmentator_part4_muscles_1559subj",
          f"{_TS_URL}/v2.0.0-weights/"
          f"Dataset294_TotalSegmentator_part4_muscles_1559subj.zip"),
    295: ("Dataset295_TotalSegmentator_part5_ribs_1559subj",
          f"{_TS_URL}/v2.0.0-weights/"
          f"Dataset295_TotalSegmentator_part5_ribs_1559subj.zip"),
    297: ("Dataset297_TotalSegmentator_total_3mm_1559subj",
          f"{_TS_URL}/v2.0.0-weights/"
          f"Dataset297_TotalSegmentator_total_3mm_1559subj.zip"),
    298: ("Dataset298_TotalSegmentator_total_6mm_1559subj",
          f"{_TS_URL}/v2.0.0-weights/"
          f"Dataset298_TotalSegmentator_total_6mm_1559subj.zip"),
    299: ("Dataset299_body_1559subj",
          f"{_TS_URL}/v2.0.0-weights/Dataset299_body_1559subj.zip"),
    300: ("Dataset300_body_6mm_1559subj",
          f"{_TS_URL}/v2.0.0-weights/Dataset300_body_6mm_1559subj.zip"),
    258: ("Dataset258_lung_vessels_248subj",
          f"{_TS_URL}/v2.0.0-weights/Dataset258_lung_vessels_248subj.zip"),
    150: ("Dataset150_icb_v0",
          f"{_TS_URL}/v2.0.0-weights/Dataset150_icb_v0.zip"),
    260: ("Dataset260_hip_implant_71subj",
          f"{_TS_URL}/v2.0.0-weights/Dataset260_hip_implant_71subj.zip"),
    315: ("Dataset315_thoraxCT",
          f"{_TS_URL}/v2.0.0-weights/Dataset315_thoraxCT.zip"),
    8: ("Dataset008_HepaticVessel",
        f"{_TS_URL}/v2.0.0-weights/Dataset008_HepaticVessel.zip"),
    570: ("Dataset570_ts_liver_segments",
          f"{_TS_URL}/v2.2.0-weights/Dataset570_ts_liver_segments.zip"),
    542: ("Dataset542_BCA_inference",
          f"{_BOA_URL}/Dataset542_BCA_inference.zip"),
    543: ("Dataset543_BCA_body_parts",
          f"{_BOA_URL}/Dataset543_BCA_body_parts.zip"),
}


def download_task_weights(task_id: int, root: Path | None = None) -> Path:
    """Download and unzip one task's weights, then convert its checkpoints."""
    from boa_tpu_torch.weights.store import weights_root

    root = Path(root) if root else weights_root()
    root.mkdir(parents=True, exist_ok=True)
    if task_id not in WEIGHT_URLS:
        raise KeyError(f"no public weight URL known for task {task_id}")
    folder, url = WEIGHT_URLS[task_id]
    target = root / folder
    if target.exists():
        logger.info("Weights for task %s already present", task_id)
        return target
    logger.info("Downloading %s ...", url)
    with tempfile.TemporaryDirectory() as td:
        zpath = Path(td) / "w.zip"
        with urllib.request.urlopen(url, timeout=600) as resp, open(zpath, "wb") as f:
            shutil.copyfileobj(resp, f)
        with zipfile.ZipFile(zpath) as z:
            rroot = root.resolve()
            for m in z.namelist():
                if not (rroot / m).resolve().is_relative_to(rroot):
                    raise ValueError(f"unsafe path in weights zip: {m!r}")
            z.extractall(root)
            tops = {m.split("/", 1)[0] for m in z.namelist() if m.strip("/")}
    if not target.exists():
        # a re-packaged release may name its root folder differently
        if len(tops) == 1 and (root / next(iter(tops))).is_dir():
            (root / next(iter(tops))).rename(target)
        else:
            raise FileNotFoundError(
                f"weights zip for task {task_id} did not contain the expected folder "
                f"{folder!r} (found: {sorted(tops)})")
    _preconvert_checkpoints(target)
    return target


def _preconvert_checkpoints(dataset_dir: Path) -> None:
    """Convert every fold's torch checkpoint to `.npz` in place, so the first
    prediction does not pay the conversion; a failure leaves it to the lazy
    conversion of `ModelStore.load`."""
    from boa_tpu_torch.plans.plans import ModelPlans
    from boa_tpu_torch.weights import convert as cv

    for mdir in sorted(Path(dataset_dir).glob("*__*__*")):
        try:
            plans = ModelPlans.from_model_folder(
                mdir, configuration=mdir.name.split("__")[-1])
            cfg = plans.arch_config()
            for fold_dir in sorted(mdir.glob("fold_*")):
                pth = fold_dir / "checkpoint_final.pth"
                npz = fold_dir / "checkpoint_final.npz"
                if pth.exists() and not npz.exists():
                    cv.save_params_npz(cv.convert_checkpoint(pth, cfg), npz)
        except Exception:
            logger.warning("Checkpoint pre-conversion failed for %s; conversion will "
                           "happen at load time", mdir, exc_info=True)


def download_for_tasks(task_names: list[str], root: Path | None = None) -> list[Path]:
    from boa_tpu_torch.tasks.registry import BCA_TASKS, TASKS

    ids: list[int] = []
    for name in task_names:
        if name == "bca":
            ids += [542, 543]
            continue
        cfg = TASKS.get(name) or BCA_TASKS.get(name)
        if cfg is None:
            raise KeyError(f"unknown task {name}")
        ids += list(cfg.task_ids)
    return [download_task_weights(tid, root) for tid in dict.fromkeys(ids)]


def list_installed(root: Path | None = None) -> list[str]:
    from boa_tpu_torch.weights.store import weights_root

    root = Path(root) if root else weights_root()
    if not root.exists():
        return []
    return sorted(p.name for p in root.iterdir() if p.is_dir())


def verify_model_dirs(paths, device) -> int:
    """Build every fold of every model folder under `paths` (a model folder,
    a dataset folder holding them, or a store root) into the network on
    `device`; returns the number of folds built. Raises where a fold does not
    fit its plans."""
    from boa_tpu_torch.plans.plans import ModelPlans
    from boa_tpu_torch.weights.convert import params_from_numpy
    from boa_tpu_torch.weights.store import load_fold

    n = 0
    for path in paths:
        path = Path(path)
        mdirs = ([path] if (path / "plans.json").exists() else
                 sorted(path.glob("*__*__*")) + sorted(path.glob("Dataset*/*__*__*")))
        for mdir in mdirs:
            conf = mdir.name.rsplit("__", 1)[-1]
            try:
                plans = ModelPlans.from_model_folder(mdir, configuration=conf)
            except KeyError:
                plans = ModelPlans.from_model_folder(mdir)
            cfg = plans.arch_config()
            for fold_dir in sorted(mdir.glob("fold_*")):
                params_from_numpy(load_fold(fold_dir, cfg), cfg, device=device)
                n += 1
    return n


def main(argv=None) -> None:
    from boa_tpu_torch.device import named_device
    from boa_tpu_torch.weights.store import import_torch_model_folder, weights_root

    dev_opt = argparse.ArgumentParser(add_help=False)
    dev_opt.add_argument("-d", "--device", default="gpu",
                         help="where the written models are checked: gpu (default: "
                              "the card), gpu:N, or cpu")
    ap = argparse.ArgumentParser("boa_tpu_torch-weights")
    sub = ap.add_subparsers(dest="cmd", required=True)
    d = sub.add_parser("download", parents=[dev_opt],
                       help="download public weight releases")
    d.add_argument("tasks", nargs="+")
    d.add_argument("--root", type=Path, default=None)
    i = sub.add_parser("import", parents=[dev_opt],
                       help="import a torch nnU-Net model folder")
    i.add_argument("folder", type=Path)
    i.add_argument("--root", type=Path, default=None)
    sub.add_parser("list", help="list installed model folders")
    e = sub.add_parser("export", parents=[dev_opt],
                       help="export a training output (train/run_training.py) into "
                            "the servable store")
    e.add_argument("training_dir", type=Path)
    e.add_argument("--task-id", type=int, required=True)
    e.add_argument("--name", required=True)
    e.add_argument("--root", type=Path, default=None)
    e.add_argument("--fold", type=int, default=0)
    e.add_argument("--trainer", default="nnUNetTrainer",
                   help="trainer name of the entry (a task's, to serve it as that "
                        "task: nnUNetTrainer_4000epochs_NoMirroring for total_fast)")
    s = sub.add_parser("create-synthetic", parents=[dev_opt],
                       help="random-weight model at a task's architecture")
    s.add_argument("--task", default="total_fast")
    s.add_argument("--root", type=Path, default=None)
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    if args.cmd == "list":
        for name in list_installed():
            print(name)
        print(f"(root: {weights_root()})")
        return
    dev = named_device(args.device)
    if args.cmd == "download":
        outs = download_for_tasks(args.tasks, args.root)
    elif args.cmd == "import":
        outs = [import_torch_model_folder(args.folder, args.root)]
        print(f"imported to {outs[0]}")
    elif args.cmd == "export":
        from boa_tpu_torch.weights.store import export_trained_model

        outs = [export_trained_model(args.training_dir, args.task_id, args.name,
                                     root=args.root, trainer=args.trainer,
                                     fold=args.fold)]
        print(f"exported to {outs[0]}")
    else:
        from boa_tpu_torch.inference.pipeline import class_map_for_task
        from boa_tpu_torch.tasks.registry import TASKS, get_task
        from boa_tpu_torch.weights.store import create_synthetic_model

        cfg = TASKS.get(args.task) or get_task(args.task)
        names = ["background"] + list(class_map_for_task(cfg.name).values())
        outs = []
        for tid in cfg.task_ids:
            outs.append(create_synthetic_model(
                args.root or weights_root(), tid, f"synthetic_{cfg.name}",
                num_classes=len(names), trainer=cfg.trainer, patch_size=(128, 128, 128),
                spacing=cfg.resample or (1.5, 1.5, 1.5),
                features=(32, 64, 128, 256, 320, 320), n_folds=1, label_names=names))
            print(f"created {outs[-1]}")
    print(f"checked {verify_model_dirs(outs, dev)} fold(s) on {dev}")


if __name__ == "__main__":
    main()
