"""The `TotalSegmentator` command of the port.

Counterpart of `boa_tpu/tools/total_segmentator.py`
(`totalsegmentator/bin/TotalSegmentator.py:1-211`): the reference's flag
table mapped onto :func:`boa_tpu_torch.python_api.totalsegmentator`. Run as
`python -m boa_tpu_torch.tools.total_segmentator -i ct.nii.gz -o out/ ...`;
`-d` defaults to the card ("gpu"), `-d cpu` runs on the host.
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path

from boa_tpu_torch.version import __version__


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="TotalSegmentator",
        description="Segment 104/117 anatomical structures in CT/MR images.")
    p.add_argument("-i", metavar="filepath", dest="input", type=Path,
                   required=True,
                   help="CT nifti image, or directory of DICOM slices")
    p.add_argument("-o", metavar="directory", dest="output", type=Path,
                   required=True, help="Output directory (or file for -ml)")
    p.add_argument("-ot", "--output_type", type=str, nargs="+",
                   choices=["nifti", "dicom_seg", "dicom_rtstruct"],
                   default=["nifti"], help="Output formats")
    p.add_argument("-ml", "--ml", action="store_true", default=False,
                   help="Save one multilabel image for all classes")
    p.add_argument("-nr", "--nr_thr_resamp", type=int, default=1,
                   help="Nr of threads for resampling (device-side here)")
    p.add_argument("-ns", "--nr_thr_saving", type=int, default=6,
                   help="Nr of threads for saving segmentations")
    p.add_argument("-f", "--fast", action="store_true", default=False,
                   help="Run faster lower resolution model (3mm)")
    p.add_argument("-ff", "--fastest", action="store_true", default=False,
                   help="Run even faster lower resolution model (6mm)")
    p.add_argument("-t", "--nora_tag", type=str, default="None",
                   help="tag in nora as mask (accepted; no nora node here)")
    p.add_argument("-p", "--preview", action="store_true", default=False,
                   help="Generate a png preview of the segmentation")
    p.add_argument("-ta", "--task", type=str, default="total",
                   help="Task to run (total, body, lung_vessels, ...)")
    p.add_argument("-rs", "--roi_subset", type=str, nargs="+", default=None,
                   help="Predict only this subset of classes (total only); "
                        "runs a rough crop pre-pass for speed")
    p.add_argument("-rsr", "--roi_subset_robust", type=str, nargs="+",
                   default=None,
                   help="Like roi_subset but uses the more robust 3mm model "
                        "for the crop pre-pass")
    p.add_argument("-rc", "--robust_crop", action="store_true", default=False,
                   help="Use the 3mm model instead of 6mm for cropping")
    p.add_argument("-ho", "--higher_order_resampling", action="store_true",
                   default=False,
                   help="Resample probabilities (order 1 one-hot) instead "
                        "of nearest labels when going back to the original "
                        "grid — smoother borders, slower")
    p.add_argument("-s", "--statistics", action="store_true", default=False,
                   help="Calculate volume (mm3) and mean intensity; results "
                        "in statistics.json")
    p.add_argument("-r", "--radiomics", action="store_true", default=False,
                   help="Calculate radiomics features (pyradiomics)")
    p.add_argument("-sii", "--stats_include_incomplete", action="store_true",
                   default=False,
                   help="Include masks touching the border in statistics")
    p.add_argument("-cp", "--crop_path", type=Path, default=None,
                   help="Custom path for the reusable crop mask")
    p.add_argument("-bs", "--body_seg", action="store_true", default=False,
                   help="Run a rough body segmentation first and crop to it")
    p.add_argument("-fs", "--force_split", action="store_true", default=False,
                   help="(reference flag) process in 3 z-chunks; the device-"
                        "resident pipeline does not need it")
    p.add_argument("-ss", "--skip_saving", action="store_true", default=False,
                   help="Skip saving of segmentations")
    p.add_argument("-ndm", "--no_derived_masks", action="store_true",
                   default=False,
                   help="Do not create derived body/skin masks")
    p.add_argument("-v1o", "--v1_order", action="store_true", default=False,
                   help="Return total-task classes in the v1 (104) order")
    p.add_argument("-rmb", "--remove_small_blobs", action="store_true",
                   default=False,
                   help="Remove small (<0.2ml) connected components")
    p.add_argument("-d", "--device", type=str, default="gpu",
                   help="Device: gpu (the card; also cuda, gpu:N) or cpu")
    p.add_argument("-q", "--quiet", action="store_true", default=False)
    p.add_argument("-sp", "--save_probabilities", type=Path, default=None,
                   help="Save class probabilities (.npz + .pkl) to this "
                        "path. Experienced users only.")
    p.add_argument("-v", "--verbose", action="store_true", default=False)
    p.add_argument("-l", "--license_number", type=str, default=None,
                   help="License number for gated tasks (stored in config)")
    p.add_argument("--test", metavar="0|1|3", choices=[0, 1, 3], type=int,
                   default=0, help="Fake-inference hook for pipeline tests")
    p.add_argument("--version", action="version", version=__version__)
    return p


def main(argv=None) -> None:
    args = get_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbose
        else (logging.WARNING if args.quiet else logging.INFO))

    from boa_tpu_torch.python_api import totalsegmentator

    totalsegmentator(
        args.input, args.output, ml=args.ml,
        nr_thr_resamp=args.nr_thr_resamp, nr_thr_saving=args.nr_thr_saving,
        fast=args.fast, nora_tag=args.nora_tag, preview=args.preview,
        task=args.task, roi_subset=args.roi_subset,
        statistics=args.statistics, radiomics=args.radiomics,
        crop_path=args.crop_path, body_seg=args.body_seg,
        force_split=args.force_split,
        output_type=args.output_type[0] if len(args.output_type) == 1
        else args.output_type,
        quiet=args.quiet, verbose=args.verbose, test=args.test,
        skip_saving=args.skip_saving, device=args.device,
        license_number=args.license_number,
        statistics_exclude_masks_at_border=not args.stats_include_incomplete,
        no_derived_masks=args.no_derived_masks, v1_order=args.v1_order,
        fastest=args.fastest, roi_subset_robust=args.roi_subset_robust,
        remove_small_blobs=args.remove_small_blobs,
        robust_crop=args.robust_crop,
        higher_order_resampling=args.higher_order_resampling,
        save_probabilities=args.save_probabilities)


if __name__ == "__main__":
    main()
