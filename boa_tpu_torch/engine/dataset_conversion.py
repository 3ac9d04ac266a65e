"""Raw-dataset conversion, on the host.

Counterpart of `boa_tpu/engine/dataset_conversion.py`, a copy on the
port's NIfTI codec (whose files are byte-identical to the reference's):
`generate_dataset_json` (nnU-Net's `generate_dataset_json.py:6-110`),
`split_4d_nifti` and `convert_msd_dataset`
(`nnUNetv2_convert_MSD_dataset`, `convert_MSD_dataset.py:13-127`: a
Medical Segmentation Decathlon task folder -> the v2 raw layout, 4D channel
stacks split into `_0000`, `_0001`, ... files, the v1 dataset.json
rewritten). The per-dataset recipe scripts of nnU-Net are not mirrored.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import re
import shutil
from pathlib import Path

import numpy as np

logger = logging.getLogger(__name__)


def generate_dataset_json(output_folder: str | Path,
                          channel_names: dict,
                          labels: dict,
                          num_training_cases: int,
                          file_ending: str,
                          regions_class_order: tuple | None = None,
                          dataset_name: str | None = None,
                          reference: str | None = None,
                          release: str | None = None,
                          citation: str | None = None,
                          description: str | None = None,
                          overwrite_image_reader_writer: str | None = None,
                          license: str | None = None,
                          converted_by: str | None = None,
                          **extra) -> dict:
    """Write `dataset.json` into `output_folder` and return the dict.

    channel_names: {index: name} (keys coerced to str — JSON requires it).
    labels: {name: int} or, for region-based training, {name: (ints…)};
    any region entry requires `regions_class_order` (the painting order
    the label manager uses at export time).
    """
    norm_channels = {str(k): v for k, v in channel_names.items()}
    norm_labels: dict = {}
    has_regions = False
    for name, value in labels.items():
        if isinstance(value, (tuple, list)):
            value = tuple(int(v) for v in value)
            has_regions = has_regions or len(value) > 1
            norm_labels[name] = value
        else:
            norm_labels[name] = int(value)
    if has_regions and regions_class_order is None:
        raise ValueError(
            "labels define regions (tuple values) — regions_class_order "
            "is required so exported segmentations paint regions in a "
            "defined order")

    dataset_json: dict = {
        "channel_names": norm_channels,
        "labels": norm_labels,
        "numTraining": int(num_training_cases),
        "file_ending": file_ending,
    }
    optional = {
        "name": dataset_name, "reference": reference, "release": release,
        "citation": citation, "description": description,
        "overwrite_image_reader_writer": overwrite_image_reader_writer,
        "licence": license, "converted_by": converted_by,
        "regions_class_order": (list(regions_class_order)
                                if regions_class_order is not None else None),
    }
    dataset_json.update({k: v for k, v in optional.items() if v is not None})
    dataset_json.update(extra)

    output_folder = Path(output_folder)
    output_folder.mkdir(parents=True, exist_ok=True)
    (output_folder / "dataset.json").write_text(
        json.dumps(dataset_json, indent=2))
    return dataset_json


def split_4d_nifti(filename: str | Path, output_folder: str | Path) -> list[Path]:
    """MSD stores multi-channel cases as one 4D NIfTI; nnU-Net v2 wants one
    3D file per channel suffixed `_0000`, `_0001`, … 3D inputs are linked
    through unchanged (just renamed with the `_0000` suffix)."""
    from boa_tpu_torch.io import nifti

    filename = Path(filename)
    output_folder = Path(output_folder)
    output_folder.mkdir(parents=True, exist_ok=True)
    base = filename.name
    for suff in (".nii.gz", ".nii"):
        if base.endswith(suff):
            base = base[: -len(suff)]
            break

    img = nifti.load(filename)
    if img.data.ndim == 3:
        out = output_folder / f"{base}_0000.nii.gz"
        shutil.copy(filename, out)
        return [out]
    if img.data.ndim != 4:
        raise ValueError(
            f"cannot split {filename}: expected 3D or 4D, got {img.data.ndim}D")
    outs = []
    for c in range(img.data.shape[3]):
        vol = np.ascontiguousarray(img.data[..., c])
        out = output_folder / f"{base}_{c:04d}.nii.gz"
        nifti.save(nifti.NiftiImage(data=vol, affine=img.affine), out)
        outs.append(out)
    return outs


def _raw_root(raw_root: str | Path | None) -> Path:
    root = raw_root or os.environ.get("nnUNet_raw") or os.environ.get(
        "BOA_RAW_PATH")
    if root is None:
        raise ValueError(
            "no raw-dataset root: pass raw_root or set nnUNet_raw/"
            "BOA_RAW_PATH")
    return Path(root)


def convert_msd_dataset(source_folder: str | Path,
                        overwrite_target_id: int | None = None,
                        raw_root: str | Path | None = None) -> Path:
    """Convert one extracted MSD task folder (TaskXX_name) into the raw
    layout under `raw_root` as DatasetXXX_name. Returns the target path."""
    source_folder = Path(source_folder)
    m = re.match(r"Task(\d+)_(.+)", source_folder.name)
    if m is None:
        raise ValueError(
            f"{source_folder.name!r} is not an MSD task folder "
            "(expected TaskXX_name)")
    task_id = int(m.group(1)) if overwrite_target_id is None \
        else int(overwrite_target_id)
    dataset_name = m.group(2)

    for sub in ("imagesTr", "labelsTr"):
        if not (source_folder / sub).is_dir():
            raise FileNotFoundError(f"{sub}/ missing in {source_folder}")
    ds_file = source_folder / "dataset.json"
    if not ds_file.is_file():
        raise FileNotFoundError(f"dataset.json missing in {source_folder}")

    root = _raw_root(raw_root)
    taken = [p.name for p in root.glob(f"Dataset{task_id:03d}_*")]
    if taken:
        raise FileExistsError(
            f"dataset id {task_id} already taken by {taken}; pass "
            "overwrite_target_id to renumber")
    target = root / f"Dataset{task_id:03d}_{dataset_name}"

    def _nii_files(sub: str) -> list[Path]:
        d = source_folder / sub
        if not d.is_dir():
            return []
        return sorted(p for p in d.glob("*.nii.gz")
                      if not p.name.startswith((".", "_")))

    n_train = 0
    for f in _nii_files("imagesTr"):
        split_4d_nifti(f, target / "imagesTr")
        n_train += 1
    for f in _nii_files("imagesTs"):
        split_4d_nifti(f, target / "imagesTs")
    (target / "labelsTr").mkdir(parents=True, exist_ok=True)
    for f in _nii_files("labelsTr"):
        shutil.copy(f, target / "labelsTr" / f.name)

    # v1 dataset.json: labels keyed by index ({"0": "background", …}) and
    # channels under "modality"; v2 inverts labels and renames the key
    ds = json.loads(ds_file.read_text())
    ds["labels"] = {name: int(idx) for idx, name in ds["labels"].items()}
    ds["file_ending"] = ".nii.gz"
    ds["channel_names"] = ds.pop("modality")
    ds.pop("training", None)
    ds.pop("test", None)
    ds.setdefault("numTraining", n_train)
    (target / "dataset.json").write_text(json.dumps(ds, indent=2))
    logger.info("converted %s -> %s (%d training cases)",
                source_folder.name, target.name, n_train)
    return target


def main(argv=None) -> None:
    """`nnUNetv2_convert_MSD_dataset` equivalent."""
    p = argparse.ArgumentParser(description=convert_msd_dataset.__doc__)
    p.add_argument("-i", required=True, help="extracted MSD task folder")
    p.add_argument("-overwrite_id", type=int, default=None)
    p.add_argument("--raw-root", default=None,
                   help="target root (default: $nnUNet_raw / $BOA_RAW_PATH)")
    a = p.parse_args(argv)
    convert_msd_dataset(a.i, a.overwrite_id, a.raw_root)


if __name__ == "__main__":
    main()
