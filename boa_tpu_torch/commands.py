"""End-to-end study orchestrator: a CT file or DICOM series to its files
and `output.xlsx`.

Counterpart of `boa_tpu/commands.py` (body_organ_analysis
`commands.py:41-288`): the same `analyze_ct` stages and stats keys, the same
workbook sheets and `debug_information.txt`. Each stage's wall time is a
`_timed` span; `RunDebugFile` sends every log record of the run to the
debug file behind an environment header. The input is a NIfTI file or a
DICOM series directory, which the ingest stage (`io/dicom_io.py`) writes
to `image.nii.gz` with its metadata rows for the `info` sheet. Where the
port differs: the header names torch and the device (with the card's
name), `BOA_PROFILE` records a `torch.profiler` trace, and `device` and
`store` reach `compute_all_models`. A trained sklearn contrast bundle
(`BOA_CONTRAST_MODEL`) answers the contrast rows; where it cannot be read
(sklearn missing, say), the contrast stage fails alone, as in the
reference: the other outputs are written and the traceback goes to
`debug_information.txt`.
"""

from __future__ import annotations

import contextlib
import logging
import os
import platform
import sys
import traceback
from pathlib import Path
from time import time
from typing import Any, Iterable, Iterator

import numpy as np
import torch

from boa_tpu_torch.bca.definitions import BodyRegion
from boa_tpu_torch.compute import contrast
from boa_tpu_torch.compute.bca_metrics import compute_bca_metrics
from boa_tpu_torch.compute.inference import compute_all_models
from boa_tpu_torch.compute.ts_metrics import compute_segmentator_metrics
from boa_tpu_torch.device import resolve_device
from boa_tpu_torch.io import nifti, xlsx
from boa_tpu_torch.io.dicom_io import get_image_info
from boa_tpu_torch.io.xlsx import Table
from boa_tpu_torch.ops.connected_components import histogram_u8
from boa_tpu_torch.utils.misc import ADDITIONAL_MODELS_OUTPUT_NAME
from boa_tpu_torch.utils.stages import HostWorker
from boa_tpu_torch.version import __version__

logger = logging.getLogger(__name__)


def _resolve_githash() -> str:
    """Best-effort repo hash for the provenance rows."""
    try:
        root = Path(__file__).resolve().parent.parent / ".git"
        head = (root / "HEAD").read_text().strip()
        if head.startswith("ref: "):
            ref = root / head[5:]
            if ref.exists():
                return ref.read_text().strip()[:12]
            packed = root / "packed-refs"
            if packed.exists():
                for line in packed.read_text().splitlines():
                    if line.endswith(head[5:]):
                        return line.split()[0][:12]
            return "unknown"
        return head[:12]
    except Exception:
        return "unknown"


__githash__ = _resolve_githash()


class RunDebugFile:
    """Per-run ``debug_information.txt``: the environment header, then every
    log record emitted anywhere in the process during the run (the console
    never sees the header). ``append_raw`` writes raw text (tracebacks)
    into the same file. ``__enter__`` writes the header and hooks a
    ``FileHandler`` onto the root logger; ``__exit__`` logs an exception in
    flight, then unhooks."""

    def __init__(self, path: Path, header: str = "") -> None:
        self.path = Path(path)
        self.header = header
        self._handler: logging.FileHandler | None = None

    def __enter__(self) -> "RunDebugFile":
        self.path.write_text(self.header)
        fh = logging.FileHandler(self.path, mode="a")
        fh.setFormatter(logging.Formatter(
            fmt="%(asctime)s | %(levelname)-8s | %(name)s | %(message)s"))
        logging.getLogger().addHandler(fh)
        self._handler = fh
        return self

    def append_raw(self, text: str) -> None:
        """Write `text` verbatim to the debug file."""
        text = text if text.endswith("\n") else text + "\n"
        fh = self._handler
        if fh is None:  # outside the context: a plain append
            with self.path.open("a") as f:
                f.write(text)
            return
        with fh.lock:  # serialize against concurrent emit() calls
            fh.stream.write(text)
            fh.flush()

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is not None:
            logger.error("analyze_ct aborted with %s", exc_type.__name__,
                         exc_info=(exc_type, exc, tb))
        fh = self._handler
        self._handler = None
        if fh is not None:
            logging.getLogger().removeHandler(fh)
            fh.close()


@contextlib.contextmanager
def _timed(stats: dict[str, Any], key: str | None, label: str) -> Iterator[None]:
    """Stage span: on exit, log the wall time and (if keyed) record it."""
    t0 = time()
    yield
    dt = time() - t0
    logger.info("%s took %.5f s", label, dt)
    if key is not None:
        stats[key] = dt


@contextlib.contextmanager
def _profiled(profile_dir: str, device: torch.device) -> Iterator[None]:
    """The study under torch.profiler; the trace goes to
    `<profile_dir>/trace.json` (chrome trace format)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    Path(profile_dir).mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(Path(profile_dir) / "trace.json"))


def _device_name(device: torch.device) -> str:
    if device.type != "cuda":
        return str(device)
    return f"{device} ({torch.cuda.get_device_name(device)})"


def _environment_header(device: torch.device, models: list[str], fast_bca: bool,
                        fast_total: bool, contrast_on: bool, pdf: bool) -> str:
    """Plain-text run provenance at the top of the debug file; the first
    line starts with ``Platform:``."""
    rows = [
        ("Platform", platform.system()),
        ("Python version", sys.version),
        ("BOA version", __version__),
        ("BOA githash", __githash__),
        ("Torch version", torch.__version__),
        ("CUDA version", torch.version.cuda),
        ("Device", _device_name(device)),
        ("Fast BCA", fast_bca),
        ("Fast Total", fast_total),
        ("Contrast Prediction", contrast_on),
        ("PDF generation", pdf),
        ("Models", models),
    ]
    return "".join(f"{k}: {v}\n" for k, v in rows) + "\n"


def _load_study(input_folder: Path, out: Path) -> tuple[Path, list[dict[str, Any]]]:
    """The input as a NIfTI path, with the DICOM metadata rows if it is a
    series: a series is validated and written to `out/image.nii.gz`."""
    if input_folder.is_file() and ".nii" in input_folder.name.lower():
        return input_folder, []
    return get_image_info(input_folder=input_folder, output_folder=out)


def _bca_regions_flag(seg_output: Path) -> int | None:
    """Presence bitmask (1 abdomen, 2 thorax, 4 brain) from the saved
    body-regions map, for runs that reused the BCA files."""
    regions_path = seg_output / "body_regions.nii.gz"
    if not regions_path.is_file():
        return None
    regions = np.asarray(nifti.load(regions_path).data)
    hist = histogram_u8(regions) if regions.dtype == np.uint8 \
        else np.bincount(regions.ravel().astype(np.intp), minlength=256)
    flag = 0
    for bit, region in ((1, BodyRegion.ABDOMINAL_CAVITY),
                        (2, BodyRegion.THORACIC_CAVITY),
                        (4, BodyRegion.BRAIN)):
        if hist[int(region)]:
            flag |= bit
    return flag


def _predict_contrast(ct_path: Path, seg_output: Path, ct_info: list,
                      stats: dict[str, Any]) -> None:
    """IV-phase and GIT contrast rows (info sheet and stats)."""
    with _timed(stats, None, "Contrast phase prediction"):
        result = contrast.predict(ct_path=ct_path, segmentation_folder=seg_output)
    ct_info.append({"name": "PredictedContrastPhase",
                    "value": result["phase_ensemble_predicted_class"]})
    ct_info.append({"name": "PredictedContrastInGIT",
                    "value": result["git_ensemble_predicted_class"]})
    if result.get("git_classifier_is_standin", False):
        ct_info.append({"name": "PredictedContrastInGITNote",
                        "value": "stand-in classifier trained on synthetic "
                                 "phantoms; NOT clinically validated"})
    stats["iv_contrast_phase"] = result["phase_ensemble_prediction"]
    stats["git_contrast"] = result["git_ensemble_prediction"]


def analyze_ct(
    input_folder: Path,
    processed_output_folder: Path,
    excel_output_folder: Path,
    models: Iterable[str],
    compute_contrast_information: bool = True,
    total_preview: bool = True,
    device=None,
    license_number: str | None = None,
    bca_median_filtering: bool = False,
    bca_examined_body_region: str | None = None,
    bca_pdf: bool = True,
    recompute: bool = False,
    fast_bca: bool = False,
    fast_total: bool = False,
    cnr_adjustment: bool = False,
    theme: str = "light",
    nr_thr_resamp: int = 1,          # accepted for API parity; resampling
    nr_thr_saving: int = 6,          # runs on the card, saves on `worker`
    nnunet_verbose: bool = False,
    fake_predict=None,
    worker: HostWorker | None = None,
    store=None,
    spans: dict | None = None,
) -> tuple[Path, dict[str, Any]]:
    """Full study analysis; returns (excel path, stats dict).

    `device` defaults to the card; `store` to `ModelStore()`
    (`$BOA_WEIGHTS_PATH`). A shared `worker` (utils/stages.HostWorker)
    carries this study's file saves into the caller's next work, and the
    caller reaps it; without one every file is on disk when this returns.
    `spans`, when given, receives `compute_all_models`' stage seconds.
    `input_folder` is a NIfTI file or a DICOM series directory.
    `total_preview` writes `preview_total.png` and `bca_pdf` `report.pdf`
    (the reference's defaults). An input that does not exist raises before
    any work."""
    input_folder = Path(input_folder)
    processed_output_folder = Path(processed_output_folder)
    excel_output_folder = Path(excel_output_folder)
    models = list(models)
    device = resolve_device(device)
    if not input_folder.exists():
        raise FileNotFoundError(f"input {input_folder} does not exist")
    processed_output_folder.mkdir(parents=True, exist_ok=True)
    excel_output_folder.mkdir(parents=True, exist_ok=True)

    debug = RunDebugFile(
        processed_output_folder / "debug_information.txt",
        header=_environment_header(device, models, fast_bca, fast_total,
                                   compute_contrast_information, bca_pdf))
    # BOA_PROFILE=<dir>: a torch.profiler trace of the whole study
    profile_dir = os.environ.get("BOA_PROFILE")
    profiler_ctx = _profiled(profile_dir, device) if profile_dir else contextlib.nullcontext()

    own_worker = worker is None
    worker_ctx = HostWorker() if own_worker else contextlib.nullcontext(worker)
    with debug, profiler_ctx, worker_ctx as worker:
        if cnr_adjustment and "heartchambers_highres" not in models:
            logger.warning(
                "--cnr-adjustment is enabled but 'heartchambers_highres' is "
                "not among the selected models: the CNR-adjusted pulmonary "
                "artery measurement will not be computed. The aorta and "
                "autochthon measurements (from 'total') are unaffected.")

        stats: dict[str, Any] = {"git_hash": __githash__, "boa_version": __version__}
        start_total = time()

        # -- stage: ingest --------------------------------------------------
        with _timed(stats, None, "Study ingest"):
            ct_path, dicom_info = _load_study(input_folder, processed_output_folder)
        ct_info: list[dict[str, Any]] = [
            {"name": "BOAVersion", "value": __version__},
            {"name": "BOAGitHash", "value": __githash__},
            *dicom_info,
        ]

        # -- stage: segmentation models ------------------------------------
        seg_output = processed_output_folder
        seg_images: dict[str, Any] = {}  # in-memory segs for the metrics
        with _timed(stats, "inference_time", "All segmentation models"):
            ct_stats = compute_all_models(
                ct_path=ct_path,
                segmentation_folder=seg_output,
                models_to_compute=models,
                fast_bca=fast_bca,
                force_split_threshold=400,
                totalsegmentator_params={
                    "preview": total_preview,
                    "fast": fast_total,
                    "license_number": license_number,
                },
                bca_params={
                    "median_filtering": bca_median_filtering,
                    "examined_body_region": bca_examined_body_region,
                    "save_pdf": bca_pdf,
                    "theme": theme,
                },
                recompute=recompute,
                cnr_adjustment=cnr_adjustment,
                store=store,
                fake_predict=fake_predict,
                worker=worker,
                images_out=seg_images,
                device=device,
                spans=spans,
            )
        stats.update(ct_stats)

        # -- stage: BCA workbook rows ---------------------------------------
        aggr = slices = slices_no_limbs = None
        if "bca" in models:
            with _timed(stats, "bca_metrics_time", "BCA metrics"):
                aggr, slices, slices_no_limbs = compute_bca_metrics(output_path=seg_output)
            if "bca_regions" not in stats:
                flag = _bca_regions_flag(seg_output)
                if flag is not None:
                    stats["bca_regions"] = flag

        # -- stage: TotalSegmentator workbook rows ----------------------------
        regions = cnr = None
        if any(a in models for a in (*ADDITIONAL_MODELS_OUTPUT_NAME, "total")):
            with _timed(stats, "totalsegmentator_metrics_time", "TotalSegmentator metrics"):
                region_information, regions, cnr = compute_segmentator_metrics(
                    ct_path=ct_path, segmentation_folder=seg_output,
                    store_axes=False, seg_images=seg_images)
            ct_info += region_information

        # -- stage: contrast classifier ---------------------------------------
        if compute_contrast_information and "total" in models:
            try:
                _predict_contrast(ct_path, seg_output, ct_info, stats)
            except Exception:
                logger.warning("Contrast phase prediction failed")
                debug.append_raw(traceback.format_exc())

        # -- stage: workbook --------------------------------------------------
        excel_path = excel_output_folder / "output.xlsx"
        with _timed(stats, "excel_time", "Workbook write"):
            write_output_workbook(excel_path, ct_info, regions, cnr, aggr, slices,
                                  slices_no_limbs)

        if own_worker:
            worker.close()  # every deferred save and render is on disk
        stats["total_time"] = time() - start_total
        logger.info("Complete CT analysis took %.5f s", stats["total_time"])
        return excel_path, stats


CNR_WARNING = ("These results were yielded by a modified version of BOA, "
               "adjusted for image quality assessment.")


def write_output_workbook(excel_path: Path, info: list[dict[str, Any]],
                          regions: Table | None = None, cnr: Table | None = None,
                          aggr: Table | None = None, slices: Table | None = None,
                          slices_no_limbs: Table | None = None) -> None:
    """The output.xlsx sheets of body_organ_analysis `commands.py:245-283`:
    `info` (one row per record, its name first), then each table given."""
    wb = xlsx.Workbook()
    sheet = wb.add_sheet("info")
    columns, rows = xlsx.records_table(info)
    name = columns.index("name")
    for row in rows:
        sheet.add_row([row[name], *row[:name], *row[name + 1:]])
    if regions is not None:
        wb.add_table(*regions, "regions-statistics")
    if cnr is not None:
        sheet = wb.add_table(*cnr, "cnr-adjusted", startrow=1)
        sheet.rows[0] = [(CNR_WARNING, xlsx.FMT_WARNING)]
        sheet.merge_row(0, 0, max(len(cnr[0]) - 1, 0))
    if aggr is not None:
        wb.add_table(*aggr, "bca-aggregated-measurements")
    if slices is not None:
        wb.add_table(*slices, "bca-slice-measurements")
    if slices_no_limbs is not None:
        wb.add_table(*slices_no_limbs, "bca-slice-measurements_no_ext")
    wb.save(excel_path)
