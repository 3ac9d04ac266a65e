"""Combine per-class masks into group masks or one multilabel file.

Counterpart of `boa_tpu/tools/combine_masks.py` (TotalSegmentator
`libs.py:420-500`: `combine_masks_to_multilabel_file`, `combine_masks` with
the ribs/vertebrae/lung/heart/pelvis/body group tables), on the host.
Run as `python -m boa_tpu_torch.tools.combine_masks -i <dir> -o <file> -m <group>`.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from boa_tpu_torch.io import nifti
from boa_tpu_torch.tasks import class_maps

RIB_CLASSES = [f"rib_left_{i}" for i in range(1, 13)] + \
              [f"rib_right_{i}" for i in range(1, 13)]

GROUPS: dict[str, list[str]] = {
    "ribs": RIB_CLASSES,
    "lung": ["lung_upper_lobe_left", "lung_lower_lobe_left",
             "lung_upper_lobe_right", "lung_middle_lobe_right",
             "lung_lower_lobe_right"],
    "lung_left": ["lung_upper_lobe_left", "lung_lower_lobe_left"],
    "lung_right": ["lung_upper_lobe_right", "lung_middle_lobe_right",
                   "lung_lower_lobe_right"],
    "pelvis": ["femur_left", "femur_right", "hip_left", "hip_right"],
    "body": ["body_trunc", "body_extremities"],
}


def _group_masks(class_type: str | list[str]) -> list[str]:
    if isinstance(class_type, (list, tuple)):
        return list(class_type)
    if class_type == "vertebrae":
        return list(class_maps.class_map_5_parts[
            "class_map_part_vertebrae"].values())
    if class_type == "vertebrae_ribs":
        return _group_masks("vertebrae") + RIB_CLASSES
    if class_type in GROUPS:
        return GROUPS[class_type]
    raise ValueError(f"unknown class_type {class_type}")


def combine_masks(mask_dir_or_file: Path, class_type) -> nifti.NiftiImage:
    """Binary union of the requested classes (multilabel file or mask dir)."""
    masks = _group_masks(class_type)
    p = Path(mask_dir_or_file)
    if p.is_file():
        img = nifti.load(p)
        label_map = img.get_label_map()
        if not label_map:
            # assuming `total` for an unlabeled multilabel file could
            # silently produce an all-zero mask (wrong task's label ids)
            raise ValueError(
                f"{p} carries no label-map extension; cannot resolve "
                f"class names for group {class_type!r}")
        inv = {v: k for k, v in label_map.items()}
        missing = [m for m in masks if m not in inv]
        if missing:
            raise ValueError(
                f"classes {missing[:5]} not in {p}'s label map — wrong "
                f"segmentation for group {class_type!r}?")
        labels = [inv[m] for m in masks]
        out = np.isin(np.asarray(img.data), labels).astype(np.uint8)
        return nifti.NiftiImage(data=out, affine=img.affine.copy())
    ref = None
    out = None
    for m in masks:
        f = p / f"{m}.nii.gz"
        if not f.exists():
            # the reference raises for ANY missing mask of the group
            # (libs.py combine_masks: "Did you run TotalSegmentator
            # successfully?") — a partial union would silently miss parts
            raise FileNotFoundError(
                f"Could not find {f}. Did you run TotalSegmentator "
                f"successfully?")
        img = nifti.load(f)
        if out is None:
            ref, out = img, np.zeros(img.shape, np.uint8)
        out[np.asarray(img.data) > 0.5] = 1
    if out is None:
        raise FileNotFoundError(f"no masks of group {class_type} in {p}")
    return nifti.NiftiImage(data=out, affine=ref.affine.copy())


def combine_masks_to_multilabel_file(masks_dir: Path,
                                     multilabel_file: Path) -> None:
    """Per-class binary masks → one `total` multilabel volume
    (`libs.py:420-441`)."""
    masks_dir = Path(masks_dir)
    ref_img = nifti.load(masks_dir / "liver.nii.gz")
    class_map = class_maps.get_class_map("total")
    out = np.zeros(ref_img.shape, np.uint8)
    for idx, mask in class_map.items():
        f = masks_dir / f"{mask}.nii.gz"
        if f.exists():
            img = np.asarray(nifti.load(f).data)
        else:
            print(f"Mask {mask} is missing. Filling with zeros.")
            img = np.zeros(ref_img.shape)
        out[img > 0.5] = idx
    res = nifti.NiftiImage(data=out, affine=ref_img.affine.copy())
    res.set_label_map(class_map)
    nifti.save(res, multilabel_file)


def main(argv=None) -> None:
    """CLI: combine binary masks into one mask / multilabel file
    (`bin/totalseg_combine_masks.py`)."""
    import argparse

    parser = argparse.ArgumentParser(description="Combine masks.")
    parser.add_argument("-i", metavar="directory", dest="mask_dir",
                        type=Path, required=True,
                        help="directory of per-class masks (or a "
                             "multilabel file)")
    parser.add_argument("-o", metavar="filepath", dest="output", type=Path,
                        required=True, help="output mask file")
    parser.add_argument("-m", "--masks", dest="class_type", required=True,
                        help="group to combine (ribs, lung, lung_left, "
                             "lung_right, pelvis, body, vertebrae, "
                             "vertebrae_ribs) or 'multilabel' to merge "
                             "every class into one total-labelled volume")
    args = parser.parse_args(argv)
    if args.class_type == "multilabel":
        combine_masks_to_multilabel_file(args.mask_dir, args.output)
    else:
        nifti.save(combine_masks(args.mask_dir, args.class_type),
                   args.output)
    print(f"Saved {args.output}")


if __name__ == "__main__":
    main()
