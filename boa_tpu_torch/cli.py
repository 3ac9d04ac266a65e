"""Command line front end, `python -m boa_tpu_torch`, with env-var mirrors.

Counterpart of `boa_tpu/cli.py` (body_organ_analysis `cli.py:37-294`): the
same flags, the same env-var fallbacks (`DEVICE, THEME, LICENSE_NUMBER,
FAST_BCA, FAST_TOTAL, BCA_NO_PDF, SKIP_CONTRAST_INFORMATION, VERBOSE`, and
the deprecated `PREDICT_FAST`), the same console logging (root at WARNING,
the package's loggers at INFO, shown with --verbose) and the
`BOA_TEST_ANATOMY` fake-inference hook. The input (`-i`) is a DICOM series
directory, the default `/dicoms`, or a NIfTI file. The device is the card
unless `--device cpu`; without CUDA the run stops. `--radiomics` writes
`statistics_radiomics.json` over the label files after the study; like the
reference, it reads the input as a NIfTI file, so a DICOM directory input
raises there.
"""

from __future__ import annotations

import argparse
import logging
import os
import time
import warnings
from pathlib import Path

from boa_tpu_torch.banner import print_banner
from boa_tpu_torch.utils.config import (env_bool, env_str, is_valid_license,
                                        resolve_device, resolve_models)

logger = logging.getLogger(__name__)


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        "boa_tpu_torch", description="Body and Organ Analysis on PyTorch / CUDA")
    parser.add_argument("-i", "--input-image", type=Path, default="/dicoms",
                        help="Path to the NIfTI file or DICOM directory")
    parser.add_argument("-o", "--output-dir", type=Path, default="/workspace",
                        help="Path to the output files from the BOA calculation")
    parser.add_argument("--use-study-prefix", default=False, action="store_true",
                        help="Output files will be prefixed with the study name")
    parser.add_argument("-m", "--models", type=str, default=None,
                        help=("Models to compute, separated by '+' "
                              "(e.g. total+bca), or 'all'"))
    parser.add_argument("--verbose", default=None, action="store_true",
                        help="Print additional information for debugging purposes")
    parser.add_argument("--preview", default=False, action="store_true",
                        help="Generate a png preview of segmentation")
    parser.add_argument("--force-recompute", default=False, action="store_true",
                        help=("Generate all segmentations from scratch, even "
                              "if they already exist"))
    parser.add_argument("--nr-thr-resamp", type=int, default=1,
                        help="Nr of threads for resampling (API parity; "
                             "resampling runs on the card here)")
    parser.add_argument("--nr-thr-saving", type=int, default=6,
                        help="Nr of threads for saving segmentations")
    parser.add_argument("--device", type=str, default=None,
                        help="Device: cuda, cuda:N or cpu")
    parser.add_argument("--license-number", type=str, default=None,
                        help="TotalSegmentator license number (for the "
                             "license-gated models)")
    parser.add_argument("--radiomics", default=False, action="store_true",
                        help="Calculate radiomics features for all "
                             "segmentations")
    parser.add_argument("--nnunet-verbose", default=False, action="store_true",
                        help="Print all the output logs of the model engine")
    parser.add_argument("--fast-total", default=False, action="store_true",
                        help="Use the fast 3mm total model")
    parser.add_argument("--fast-bca", default=False, action="store_true",
                        help="Run BCA with a single fold instead of the "
                             "5-fold ensemble")
    parser.add_argument("--bca-median-filtering", default=False, action="store_true",
                        help="Apply 3x3 in-plane median filtering before "
                             "tissue subclassification")
    parser.add_argument("--bca-examined-body-region", type=str, default=None,
                        choices=["abdomen", "neck", "thorax"],
                        help="Limit BCA report measurements to the selected "
                             "body region.")
    parser.add_argument("--bca-no-pdf", default=False, action="store_true",
                        help="Skip BCA PDF report generation")
    parser.add_argument("--skip-contrast-information", default=False,
                        action="store_true",
                        help="Skip IV/GIT contrast phase prediction")
    parser.add_argument("--cnr-adjustment", default=False, action="store_true",
                        help="Compute the CNR-adjusted measurement variants")
    parser.add_argument("--theme", type=str, default=None,
                        choices=["light", "dark"], help="BCA report theme")
    parser.add_argument("--triton-url", type=str, default=None,
                        help="Accepted for API parity (unused)")
    return parser


def run(argv: list[str] | None = None) -> None:
    print_banner()
    parser = get_parser()
    args = parser.parse_args(argv)

    logging.basicConfig()
    logging.getLogger().setLevel(logging.WARNING)
    logging.getLogger("boa_tpu_torch").setLevel(logging.INFO)
    verbose: bool = bool(args.verbose) or env_bool("VERBOSE", False)
    console_level = logging.INFO if verbose else logging.WARNING
    for h in logging.getLogger().handlers:
        h.setLevel(console_level)

    device = resolve_device(args.device)
    theme: str = args.theme or os.getenv("THEME", "light")
    license_number = args.license_number or env_str("LICENSE_NUMBER")
    fast_bca: bool = args.fast_bca or env_bool("FAST_BCA", False)
    fast_total: bool = args.fast_total or env_bool("FAST_TOTAL", False)
    bca_no_pdf: bool = args.bca_no_pdf or env_bool("BCA_NO_PDF", False)
    skip_contrast_information: bool = (
        args.skip_contrast_information
        or env_bool("SKIP_CONTRAST_INFORMATION", False))

    license_valid = bool(license_number) and is_valid_license(license_number)
    if license_number and not license_valid:
        raise ValueError("The provided license number is not valid.")

    # pass the verdict through: with BOA_LICENSE_BACKEND set the check is
    # a remote POST, made once
    models_to_compute = resolve_models(args.models, license_number=license_number,
                                       license_valid=license_valid)

    if "PREDICT_FAST" in os.environ:
        warnings.warn(
            "PREDICT_FAST is deprecated (removed in 1.1.0); set FAST_BCA / "
            "FAST_TOTAL or pass --fast-bca / --fast-total instead. Treating "
            "it as both for now.",
            DeprecationWarning, stacklevel=2)
        fast_bca = True
        fast_total = True

    # fake-inference hook (the reference's `test=N` mode): the anatomy
    # phantom's labels replace every model forward
    fake_predict = None
    if env_bool("BOA_TEST_ANATOMY", False):
        from boa_tpu_torch.testing.anatomy import fake_predict_factory

        fake_predict = fake_predict_factory()

    from boa_tpu_torch.commands import analyze_ct

    analyze_ct(
        input_folder=args.input_image,
        processed_output_folder=args.output_dir,
        excel_output_folder=args.output_dir,
        models=models_to_compute,
        compute_contrast_information=not skip_contrast_information,
        total_preview=args.preview,
        nr_thr_resamp=args.nr_thr_resamp,
        nr_thr_saving=args.nr_thr_saving,
        device=device,
        license_number=license_number,
        bca_median_filtering=args.bca_median_filtering,
        bca_examined_body_region=args.bca_examined_body_region,
        bca_pdf=not bca_no_pdf,
        recompute=args.force_recompute,
        nnunet_verbose=args.nnunet_verbose,
        fast_bca=fast_bca,
        fast_total=fast_total,
        cnr_adjustment=args.cnr_adjustment,
        theme=theme,
        fake_predict=fake_predict,
    )

    if args.radiomics:
        from boa_tpu_torch.measure.radiomics import get_radiomics_features_for_entire_dir

        logger.info("Calculating radiomics...")
        st = time.time()
        get_radiomics_features_for_entire_dir(
            args.input_image, args.output_dir,
            args.output_dir / "statistics_radiomics.json", device=device)
        logger.info("  calculated in %.2fs", time.time() - st)

    if args.use_study_prefix:
        prefix = args.input_image.name.removesuffix(".nii.gz") + "_"
        # snapshot before renaming: a lazy scandir can re-surface renamed
        # entries mid-iteration and double-prefix them
        for artifact in sorted(args.output_dir.iterdir()):
            artifact.rename(artifact.with_name(prefix + artifact.name))


if __name__ == "__main__":
    run()
