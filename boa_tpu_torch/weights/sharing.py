"""Pretrained-model sharing: zip export, install, download by URL.

Counterpart of `boa_tpu/weights/sharing.py` (nnU-Net's
`model_sharing/model_export.py:6-90`, `model_import.py:6-8`,
`model_download.py:11-35`), a copy. An archive holds the store-relative
tree (DatasetXXX_name/trainer__plans__config/...), so a zip made on one
machine installs on another by extraction: the `.npz` checkpoint of each
fold (else its `.pth`), the plans and the fold's extras. Installing
refuses any member that would land outside the store (zip-slip).
"""

from __future__ import annotations

import argparse
import logging
import zipfile
from pathlib import Path

from boa_tpu_torch.weights.store import weights_root

logger = logging.getLogger(__name__)

#: per-fold files worth shipping, in preference order (first match wins
#: for the checkpoint; the rest are included when present)
_CHECKPOINTS = ("checkpoint_final.npz", "checkpoint_final.pth")
_FOLD_EXTRAS = ("debug.json", "progress.png", "progress.json",
                "network_architecture.pdf")
_MODEL_FILES = ("plans.json", "dataset.json", "dataset_fingerprint.json")


def export_pretrained_model(task_id: int, output_file: str | Path,
                            configurations=("3d_fullres",),
                            trainer: str = "nnUNetTrainer",
                            plans_name: str = "nnUNetPlans",
                            folds=(0, 1, 2, 3, 4),
                            strict: bool = True,
                            export_crossval_predictions: bool = False,
                            root: str | Path | None = None) -> Path:
    """Zip the trained model(s) for `task_id` from the weights store."""
    root = Path(root) if root else weights_root()
    matches = sorted(root.glob(f"Dataset{task_id:03d}_*"))
    if not matches:
        raise FileNotFoundError(f"no Dataset{task_id:03d}_* under {root}")
    dataset_dir = matches[0]
    output_file = Path(output_file)

    def _add(zf: zipfile.ZipFile, path: Path) -> None:
        zf.write(path, path.relative_to(root).as_posix())

    n_ckpts = 0
    with zipfile.ZipFile(output_file, "w", zipfile.ZIP_DEFLATED) as zf:
        for config in configurations:
            mdir = dataset_dir / f"{trainer}__{plans_name}__{config}"
            if not mdir.is_dir():
                if strict:
                    raise FileNotFoundError(
                        f"{dataset_dir.name} has no trained {config} model "
                        f"({mdir.name})")
                continue
            for name in _MODEL_FILES:
                if (mdir / name).is_file():
                    _add(zf, mdir / name)
            for fold in folds:
                fdir = mdir / f"fold_{fold}"
                if not fdir.is_dir():
                    raise FileNotFoundError(
                        f"requested fold {fold} missing in {mdir}")
                ckpt = next((fdir / c for c in _CHECKPOINTS
                             if (fdir / c).is_file()), None)
                if ckpt is None:
                    raise FileNotFoundError(f"no checkpoint in {fdir}")
                _add(zf, ckpt)
                n_ckpts += 1
                for name in _FOLD_EXTRAS:
                    if (fdir / name).is_file():
                        _add(zf, fdir / name)
                val = fdir / "validation"
                if val.is_dir():
                    if export_crossval_predictions:
                        for f in sorted(val.iterdir()):
                            if f.is_file() and f.suffix not in (".npz", ".pkl"):
                                _add(zf, f)
                    elif (val / "summary.json").is_file():
                        _add(zf, val / "summary.json")
            cross = sorted(mdir.glob("crossval_results_folds_*"))
            for cdir in cross:
                for f in sorted(cdir.iterdir()):
                    if f.is_file() and (export_crossval_predictions
                                        or f.suffix == ".json"):
                        _add(zf, f)
    logger.info("exported %d fold checkpoint(s) to %s", n_ckpts, output_file)
    return output_file


def install_model_from_zip(zip_file: str | Path,
                           root: str | Path | None = None) -> Path:
    """Extract a model archive into the weights store (zip-slip safe)."""
    root = Path(root) if root else weights_root()
    root.mkdir(parents=True, exist_ok=True)
    resolved_root = root.resolve()
    with zipfile.ZipFile(zip_file, "r") as zf:
        for info in zf.infolist():
            dest = (root / info.filename).resolve()
            if not dest.is_relative_to(resolved_root):
                raise ValueError(
                    f"refusing unsafe archive member {info.filename!r} "
                    "(escapes the store root)")
        zf.extractall(root)
    logger.info("installed %s into %s", zip_file, root)
    return root


def download_and_install_from_url(url: str,
                                  root: str | Path | None = None) -> Path:
    """Fetch a model zip over HTTP(S) and install it. Needs network access."""
    import tempfile
    import urllib.request

    with tempfile.NamedTemporaryFile(suffix=".zip") as tmp:
        logger.info("downloading pretrained model from %s", url)
        with urllib.request.urlopen(url, timeout=100) as resp:
            while True:
                chunk = resp.read(8192 * 16)
                if not chunk:
                    break
                tmp.write(chunk)
        tmp.flush()
        return install_model_from_zip(tmp.name, root)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        description="export/install/download pretrained model archives")
    sub = p.add_subparsers(dest="cmd", required=True)

    pe = sub.add_parser("export", help="nnUNetv2_export_model_to_zip")
    pe.add_argument("-d", type=int, required=True, help="dataset/task id")
    pe.add_argument("-o", required=True, help="output zip")
    pe.add_argument("-c", nargs="+", default=["3d_fullres"])
    pe.add_argument("-tr", default="nnUNetTrainer")
    pe.add_argument("-p", default="nnUNetPlans")
    pe.add_argument("-f", nargs="+", type=int, default=[0, 1, 2, 3, 4])
    pe.add_argument("--not_strict", action="store_true")
    pe.add_argument("--exp_cv_preds", action="store_true")

    pi = sub.add_parser("install",
                        help="nnUNetv2_install_pretrained_model_from_zip")
    pi.add_argument("zip_file")

    pd = sub.add_parser("download",
                        help="nnUNetv2_download_pretrained_model_by_url")
    pd.add_argument("url")

    a = p.parse_args(argv)
    if a.cmd == "export":
        export_pretrained_model(a.d, a.o, tuple(a.c), a.tr, a.p, tuple(a.f),
                                strict=not a.not_strict,
                                export_crossval_predictions=a.exp_cv_preds)
    elif a.cmd == "install":
        install_model_from_zip(a.zip_file)
    else:
        download_and_install_from_url(a.url)


if __name__ == "__main__":
    main()
