#!/usr/bin/env python3
"""Smoke run of the PyTorch port (boa_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile] [--phases=a,b]

Builds the CUDA kernels from boa_tpu_torch/csrc (nvcc, sm_90a), then:

1. device   - the card's name and power limit, torch/CUDA versions, build time
2. kernels  - every kernel of the main path against its plain PyTorch version
              at the shapes a 128^3 total_fast tile gives it (bf16 outputs
              at rtol = atol = 2e-2, per-channel sums within 1e-2 of the
              largest sum of squares). K1's four calls of a tile are each
              printed, and its input conv at cin = 2 and 5 (the padded
              chunk of a multi-channel input); K1 (stage 0's second conv)
              and K3 (with its bias) write and K2 reads a channel slice of
              the (1, 128, 128, 128, 64) decoder concat, as the main path
              runs them; the channels a writer does not own must keep their
              bits. CUDA-event times of the kernel's launch alone
              (`kernel_ms`: weights packed and buffers allocated beforehand),
              the public wrapper (`wrapper_ms`), the plain version and the
              closest single PyTorch library call
3. forward  - the full-width total_fast U-Net on one 128^3 tile: the kernel
              composite against the same composite on the plain versions
              (argmax agreement > 0.99), and the time per tile
4. fused    - the wide-channel conv kernel (K5) against its plain version at
              each of the 17 convs of the fused forward (same bars and
              timings as phase 2; `kernel_ms` is the launch alone,
              `pallas_conv.prepare_launch`, finishing pass included), with
              each call's K splits and blocks: every call at 16^3 and below
              must split, none at 128^3. Then the full-width fused
              forward on the same tile and model as phase 3: argmax
              agreement > 0.99 with the same forward on the plain K5 and
              > 0.98 with the eager forward, exactly 17 K5 calls and one
              finishing launch per split call, and its time per tile beside
              the composite's and the eager forward's
5. study    - a small study through predict_image on the card against the
              same call on the CPU (labels agree > 0.99), then the
              512x512x300 fast-total study (one warm-up, three timed runs)
              with per-stage spans, peak memory and the kernel launch
              counts, which must equal tiles x (4, 1, 1) on every run, with
              no K5 launch and no finishing launch
6. total    - `predict_image(img, "total", store)` without `fast`: five
              sub-models (291-295) at 1.5 mm, step 0.8, merged on the card.
              (a) small widths (32, 64, 128), 32^3 patch, on the 96x96x64
              CT: labels agree with the CPU run > 0.99, come from >= 3
              sub-models and lie in the `total` map; (b) the crop task
              liver_vessels (1 mm plan, the predictor's own resample, its
              weight-normalized logits and class-chunked argmax) on a
              liver-sized box: labels agree with the CPU run > 0.99; (c) the
              512x512x300 study at the total_fast widths (128^3 patch, 120
              tiles per sub-model on the 448x384x600 grid): one warm-up and
              two timed runs with spans (predict_291 ... predict_295), peak
              memory and each sub-model loaded once; (d) liver_vessels at
              the total_fast widths (128^3 patch) on a liver-sized box of
              the same CT: one warm-up and one timed run (seconds, spans,
              peak memory), labels in the box agree > 0.99 with the same
              run on the plain composite. Every run's launches equal tiles x
              (4, 1, 1) with no K5 launch, and K1's finishing launches are
              those its split plan gives (three a tile at 32^3, none at 128^3)
7. measure  - the measurement path from a CT file to the study's files:
              (a) `compute_all_models(ct_path, out, ["total"])` with the small
              five-model store of 6 (a) at two stages (widths 32/64) on a
              96x96x32 `.nii.gz` written by the
              port's codec, on the card and on the CPU: total.nii.gz,
              ct_pfav.nii.gz, total-statistics.json and total-measurements.json
              exist and load, labels agree > 0.99, launches as in 6 (a); (b) the
              measurement engine at 512x512x300 (every `total` class, the
              autochthon, aorta and lung lobes in blocks with muscle, contrast
              and fat HU): `get_basic_statistics` (mean, median) and
              `compute_measurements_arrays` (CNR adjustment) on the card against
              the same calls on the CPU, statistics equal, histogram-derived
              numbers equal, masked moments within 1e-6 relative, the seconds of
              each span; (c) the 512x512x300 study from its file at the
              total_fast widths through `compute_all_models`: one warm-up and one
              timed run with spans (load, body_crop, predict_291 ...
              predict_295, statistics, save, the engine's), peak memory and the
              launches of 6 (c)
8. bca      - the BCA chain from a CT file to its files: (a)
              `compute_all_models(ct_path, out, ["total", "bca"])` with the
              small five-model store of 6 (a) at two stages (widths 32/64)
              plus body_parts (543) and body_regions (542) at the same
              widths with five folds each
              (1.5 x 1.5 x 5 mm, the plans' grid, the head bias with
              background's lead) on the 96x96x32 `.nii.gz`, on the card and on
              the CPU: every promised file exists and loads, the labels of each
              `.nii.gz` agree > 0.99, bca-measurements.json has the same keys
              and Nones on both sides, launches tiles x folds x (4, 1, 1) with
              the split plan's finishing passes; (b) the BCA device passes at
              512x512x300 on the port's anatomy phantom (six body parts, 255
              fragments): `subclassify_tissues` with and without the median,
              the Builder's per-slice pass, `region_z_counts`, `prepare` (the
              density stacks) and `create_json` on the card against the CPU:
              tissues and counts equal, HU sums and the JSON within 1e-9
              relative; seconds, spans and the peak, each of the three
              bincount passes timed against a loop of masked reductions, and
              the host's parts postprocess with a thread per label against
              one thread (ABBA, equal results); (c)
              the 512x512x300 study from its file through
              `compute_all_models(["total", "bca"])` with `total` fast and both
              BCA models at the total_fast widths (128^3 patch, five folds):
              one warm-up and one timed run with seconds, spans (predict_543,
              predict_542, both postprocesses, tissues, builder, prepare, save,
              save_wait), peak memory, launches tiles x folds x (4, 1, 1) and
              each model loaded once; the warm-up alone when the cli phase
              runs too, whose (c) times the same study through the CLI
9. cli      - the front door, `python -m boa_tpu_torch`, from a CT file to its
              files and output.xlsx: (a) the command as a subprocess with
              `--device cuda` on 8 (a)'s small stores and 96x96x32 file,
              `-m total+bca --fast-bca --bca-no-pdf`, contrast on: exit 0, the
              six sheets, debug_information.txt names the card, every label
              file agrees > 0.99 with the same command in this process on the
              CPU, and the prediction counter (BOA_TPU_CONFIG_DIR) rose by the
              number of predict_image calls; (b) `analyze_ct` through the
              anatomy phantom's hook at 512x512x150 (`total+bca`, CNR
              adjustment, contrast on) on the card and on the CPU: every
              numeric cell of every sheet within 1e-6 relative, strings and
              empty cells equal; (c) `cli.run` in this process on 8 (c)'s
              file and stores, `-m total+bca --fast-total --bca-no-pdf` (five
              BCA folds, contrast on): one timed run after 8 (c)'s warm-up
              with seconds, analyze_ct's stats, spans, peak memory, launches
              tiles x folds x (4, 1, 1), no K5 launch and no model loaded
              again
10. dicom   - DICOM ingestion, from a series directory: (a) a 96x96x64
              bench CT as a JPEG-LS series (the port's `write_ct_series`) through
              `analyze_ct` with 5's small `total_fast` (widths 32/64/128,
              32^3 patch), `-m total` fast, contrast on, on the card and in
              this process on the CPU:
              image.nii.gz equal to the source voxels, total.nii.gz labels
              agree > 0.99, the info sheets' DICOM rows equal, the "Study
              ingest took" span in debug_information.txt, launches tiles x
              (4, 1, 1) with the split plan's finishing passes;
              (b) the host decoders (`boa_tpu_torch/native`, g++, their build
              seconds) on one 512x512 slice of the bench CT as RLE, JPEG
              Lossless SV1, JPEG-LS, JPEG 2000 and 12-bit JPEG Extended: the
              median of 5 decodes in ms, bit-identical to the source for the
              lossless syntaxes and to the plain Python decoder (one call;
              JPEG 2000's on the central 128x128 crop); (c) the bench's
              512x512x300 CT as an uncompressed series through `cli.run`
              (`-m total --fast-total`, contrast on) on 8 (c)'s store: seconds,
              the ingest span, analyze_ct's stats, spans, peak memory,
              launches tiles x (4, 1, 1) with no K5, image.nii.gz equal to the
              source (affine within 1e-6), total.nii.gz agreeing > 0.99 with
              9 (c)'s (or with the command on the NIfTI file when the cli phase
              did not run), and an estimate of a 300-slice JPEG-LS ingest
11. render  - the renderers (the BCA PDF, the preview and their writers):
              (a) the preview's front pass (`compute/preview.py`
              `_group_fronts_device`) on the anatomy phantom's `total` labels
              at 512x512x300 on the card, CUDA-event ms (median of 5 after a
              warm-up), against its plain host version timed once: fronts,
              label indices and label lists equal to the bit, the montages
              from both byte-identical PNGs of 1760 x 660, the montage's
              seconds; (b) `analyze_ct` through the anatomy hook at
              512x512x300 with `total_preview=True, bca_pdf=True` on the card:
              report.pdf has 3 pages + one per aggregation window,
              preview_total.png more than 50 pixels of saturation > 0.15 in
              each of its five panels, the spans of the front pass
              (`preview_fronts`), the deferred montage (`preview_render`) and
              the PDF (`report_pdf`); (c) `cli.run` on 8 (c)'s file and stores,
              `-m total+bca --fast-total --preview` with the PDF on: seconds,
              analyze_ct's stats, spans, peak memory, launches tiles x folds x
              (4, 1, 1) with no K5 and no model loaded again, both files
              written
12. api     - the TotalSegmentator API (`python_api.totalsegmentator`) and
              its writers on the full-width total_fast store, the anatomy
              phantom's hook with `run_real` (the real forward on K1-K3, the
              phantom's labels measured and written): (a) the 512x512x150
              phantom from its .nii.gz with statistics, radiomics and the
              preview, per-class masks: seconds, spans (predict, statistics,
              radiomics_histogram, radiomics_shape, save_nifti, preview),
              peak memory, launches tiles x (4, 1, 1); the 117 masks and the
              preview byte-identical to the same call on the CPU with the
              plain hook, statistics.json within 1e-3 HU with volumes equal,
              statistics_radiomics.json within 1e-9 relative with counts
              equal; (b) a 512x512x64 series of the phantom (`write_ct_series`)
              through `ml=True` with nifti, dicom_seg and dicom_rtstruct: the
              SEG read back equal to the NIfTI labels voxel for voxel, one ROI
              per present label, every contour closed, >= 3 points, on the
              pixel centres of its label's border, SEG and RTSTRUCT equal to
              the CPU run's apart from UIDs, dates and times, the writers' and
              the tracer's seconds, launches tiles x (4, 1, 1); (c) `cli.run
              -m total --fast-total --radiomics` through the anatomy hook on a
              96x96x32 phantom writes statistics_radiomics.json
13. engine  - the model-folder predictor (`python -m
              boa_tpu_torch.engine.predict`) on real-format nnU-Net
              checkpoints (`testing/nnunet_checkpoint.py`) at full width:
              (a) total_fast's network (6-stage PlainConvUNet 32->320, 118
              classes, 128^3 patch, 3 mm plan) as a results folder with two
              `checkpoint_final.pth` folds, one 192x192x96 case at 3 mm,
              nnUNetTrainer's mirror axes, `-f 0 1 -step_size 0.5
              --save_probabilities`: the conversion's, the cached .npz load's,
              the predict's and the export's seconds, peak memory; 8 network
              forwards (4 tiles x 2 folds, the 8 flips of a tile as one
              batch: 64 evaluations) counted from the model's side, K1/K2/K3
              launches (4, 1, 1) per forward with the split plan's finishing
              passes, no K5; the labels an argmax of the .npz (differences
              only at float16 ties, counted); the folder again without
              probabilities, twice, then imported into a store
              (`import_torch_model_folder`: the same parameters bit for bit)
              and `-d 297` run as a subprocess: labels within 1e-4 of the
              folder's, with the voxel counts of -d vs -m and of the two -m
              runs (the kernels' sums are atomic, so runs round apart at a few
              voxels); `-m` and `-d` again in this process with the network
              on the plain composite (no kernel launch): labels byte-identical;
              the kernel composite against the plain one on the batch the
              path sends, the case's first tile and its 7 flips: each
              sample's argmax > 0.99 and its largest logit error <= 2e-2 of
              its largest logit, and the plain composite run twice bit-equal
              (whether the kernels' is, printed). (b) nnU-Net's ResEnc M
              layout (6 stages 32->320, blocks (1, 3, 4, 6, 6, 6), one-conv
              decoder) on one 128^3 case and (c) an 8-stage 2d net (32->512,
              512x512 patch, 0.8 mm) on a 512x512x24 slice stack: one fold, no
              TTA, eager bf16 (no row-conv launch), labels against a float32
              Predictor on the card > 0.99, seconds, peak memory, the bf16 and
              fp32 forward's ms
14. tools   - the TotalSegmentator tools: (a) the gradient-descent
              registration (`ops/registration.py`) of the 1 mm brain atlas
              against a known perturbation of itself (10 degrees, scale
              1.05, a shift), levels (4, 2): NCC > 0.9, mean landmark error
              < 2 voxels, the seconds of each level, one NCC loss and its
              gradient card against CPU at rtol 1e-4; (b) `evans_index`,
              `crop_to_body`, `get_modality` (with and without -n) and
              `get_phase` as commands on full-width synthetic models, each
              on K1-K3 (launches (4, 1, 1) per forward) and on the plain
              composite: the same JSON, bbox and modality, pi_time within
              0.5; `evans_index` with the CT on a turned 2 mm atlas, card
              against CPU within 0.01, its PNG written
15. serve   - the serving layer: (a) `StreamRunner` over five 512x512x150
              phantom files, one truncated: four studies, labels equal to a
              serial predict_image on the plain composite and, on the
              kernels, apart at no more than max(1e-4, 3 x their own
              run-to-run share), volumes per minute against the serial
              loop, launches (4, 1, 1) per forward; (b) the warm-up
              command's entry over two buckets and the study's own shape in
              a fresh process, its first study against a fresh process not
              warmed, `--bake --stamp` twice (the second without a launch)
16. pacs    - the PACS front door as a hospital deploys it: Orthanc's
              STABLE_SERIES callback (`pacs/on_change.py`) -> the local queue
              -> the worker (`pacs/worker.py`, on the card: no DEVICE) -> the
              DICOMweb, SMB and Postgres sinks, around stdlib HTTP servers for
              Orthanc's REST API and STOW-RS and stand-in `orthanc`,
              `smbclient` and `psycopg2` modules: (A) dicom (c)'s 512x512x300
              series (written here when that phase did not run) on the
              full-width total_fast store: the SEG received over STOW-RS
              agrees > 0.99 with dicom (c)'s labels, the workbook, preview and
              debug file on the share, the row computed with its times; (B)
              five instances, rejected by the gate, row `none-<max id>`; (C) 20
              instances cut short: "BOA analysis failed" on the share; every
              column one of deploy/init.sql's, DELETE for all three, launches
              (A)'s tiles x (4, 1, 1) with no K5

The device phase also says whether pandas, matplotlib, cv2, PIL and sklearn
import on the card machine. With --profile, the fused, study and total phases
each add one more run under torch.profiler (device busy share, kernels by
device time), and the measure phase one more run of (b) on the card. With
--phases=a,b (of kernels, forward, fused, study, total, measure, bca, cli,
dicom, render, api, engine, tools, serve, pacs) only those phases run after the device
phase, and the kernel summary line is left out. Each phase prints one JSON line
(the total, measure, bca, cli, dicom, render, api, engine, tools and serve phases
one per part).
Then come the kernel summary line {"kernels": [...]} (K1-K3's `launches` are
the fast study's, `launches_total` the full total study's, `launches_bca` the
BCA study's, `launches_cli` the CLI study's, `launches_api` the API call's
of api (a), `launches_engine` engine (a)'s predict, `launches_tools` the
tools' commands of tools (b), `launches_serve` the stream of serve (a),
`launches_pacs` the PACS worker's series (A); K5's row has the last six too)
and, last,
{"ok": true, "device": {...}}. Any failed
check raises, so the script exits non-zero without that last line; it also
exits non-zero when CUDA is unavailable or the package is missing.
Weights are random, drawn from fixed seeds.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

ALL_PHASES = ("kernels", "forward", "fused", "study", "total", "measure", "bca", "cli",
              "dicom", "render", "api", "engine", "tools", "serve", "pacs")
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
BF16_FLOP_PER_S = 989e12    # dense bf16 tensor-core peak, same source
TOTAL_FAST_FEATURES = (32, 64, 128, 256, 320, 320)
# the small runs of the measure, bca and cli phases (card against the CPU):
# two stages, cut from the small checks' three to keep the script's time
SMALL_RUN_FEATURES = (32, 64)
SMALL_RUN_SHAPE = (96, 96, 32)   # their CT: 32 slices, cut from 64 for the same reason
STUDY_SHAPE = (512, 512, 300)   # the bench's CT, as the measure phase's (b) and (c) use it
API_SHAPE = (512, 512, 150)     # api (a)'s phantom: 150 slices, cut from 300 for the time limit
SHEETS_SHAPE = (512, 512, 150)  # cli (b)'s phantom: 150 slices, cut from 300 for the same reason
PART_IDS = (291, 292, 293, 294, 295)   # the sub-models of `total`, merged in order
BACKGROUND_LEAD = 1.0   # background's head bias over the largest other, per part
REPLACES = {
    "conv3d_rows": "boa_tpu/ops/rowconv.py:78, boa_tpu/ops/rowconv.py:334",
    "conv3d_rows_stride2": "boa_tpu/ops/rowconv.py:426",
    "transpconv2_rows": "boa_tpu/ops/rowconv.py:620",
    "conv3d_in_act": "boa_tpu/ops/pallas_conv.py:100",
}
SOURCES = {
    "conv3d_rows": "boa_tpu_torch/csrc/conv_in_act.cu",
    "conv3d_rows_stride2": "boa_tpu_torch/csrc/stride2conv.cu",
    "transpconv2_rows": "boa_tpu_torch/csrc/transpconv.cu",
    "conv3d_in_act": "boa_tpu_torch/csrc/conv_in_act.cu",
}
# the 17 K5 calls of one fused total_fast forward on a 128^3 tile:
# (extent, cin, cout, whether a norm is pending on the input). The network
# input, the conv after each stride-2 block and the decoder concats arrive
# materialized (identity norm, slope 1); the others carry the previous
# conv's instance norm (slope 0.01).
FUSED_CONVS = [
    (128, 1, 32, False), (128, 32, 32, True),
    (64, 64, 64, False), (32, 128, 128, False), (16, 256, 256, False),
    (8, 320, 320, False), (4, 320, 320, False),
    (8, 640, 320, False), (8, 320, 320, True),
    (16, 512, 256, False), (16, 256, 256, True),
    (32, 256, 128, False), (32, 128, 128, True),
    (64, 128, 64, False), (64, 64, 64, True),
    (128, 64, 32, False), (128, 32, 32, True),
]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(torch, fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float) -> tuple[float, float]:
    """(ms moving the bytes at the memory rate, ms doing the operations at
    the bf16 tensor-core peak)."""
    return nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOP_PER_S * 1e3


# ---------------------------------------------------------------------------


def phase_device(torch, _build) -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    _build.build_all()
    regs, spills = {}, {}
    for stem, log in _build.build_info["logs"].items():
        lines = log.splitlines()
        regs[stem] = sorted({int(line.split("Used ")[1].split()[0])
                             for line in lines if "registers" in line})
        spills[stem] = max((int(line.split("bytes spill stores")[0].split(",")[-1])
                            for line in lines if "bytes spill stores" in line), default=0)
    # the host packages the PDF, the workbook and the preview would need
    host_modules = {m: subprocess.run([sys.executable, "-c", f"import {m}"],
                                      capture_output=True).returncode == 0
                    for m in ("pandas", "matplotlib", "cv2", "PIL", "sklearn")}
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0), "host_modules": host_modules,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": time.perf_counter() - t0, "build_cached": _build.build_info["cached"],
          "registers_per_thread": regs, "max_spill_store_bytes": spills})
    return {"smi": smi}


def _norm(torch, ops, rng, n, cin, dev):
    return ops.NormAct(
        mean=torch.tensor(rng.normal(size=(n, cin)) * 0.1, dtype=torch.float32, device=dev),
        inv_std=torch.tensor(1.0 + rng.random((n, cin)), dtype=torch.float32, device=dev),
        gamma=torch.tensor(1.0 + 0.1 * rng.normal(size=cin), dtype=torch.float32, device=dev),
        beta=torch.tensor(0.1 * rng.normal(size=cin), dtype=torch.float32, device=dev),
        slope=0.01)


def _bits(torch, t):
    return t.contiguous().view(torch.int16)


def phase_kernels(torch, rc) -> list[dict]:
    """Each kernel at the main path's shapes against its plain version.

    `kernel_ms` times the launch alone (`rc.prepare_launch`: weights packed,
    norm rows and outputs allocated outside the timed function);
    `wrapper_ms` the public call, which packs the weights on every call."""
    import torch.nn.functional as F

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    # (kernel, n, spatial, cin, cout, slope kind, layout); the four
    # conv3d_rows calls of one tile (n = 1) are 1->32, 32->32 (stage 0) and
    # 64->32, 32->32 (decoder). Layout "concat" is the main path's: K1
    # (stage 0's second conv) and K3 (with its bias) write and K2 reads a
    # 32-channel slice of the (1, 128, 128, 128, 64) decoder concat; "dense"
    # cases take and give whole tensors; "channels" cases are the input conv
    # of a 2- or 5-channel input (K5's padded-chunk path, not the tap-folded
    # one), which `total` does not run.
    cases = [
        ("conv3d_rows", 1, 128, 1, 32, "none", "dense"),
        ("conv3d_rows", 1, 128, 32, 32, "scalar", "concat"),
        ("conv3d_rows", 1, 128, 64, 32, "vector", "dense"),
        ("conv3d_rows", 1, 128, 32, 32, "scalar", "dense"),
        ("conv3d_rows", 2, 128, 1, 32, "none", "dense"),
        ("conv3d_rows", 2, 128, 32, 32, "scalar", "dense"),
        ("conv3d_rows", 2, 128, 64, 32, "vector", "dense"),
        # a multi-channel or cascade input: cin < 16 in a padded 16-wide chunk
        ("conv3d_rows", 1, 128, 5, 32, "none", "channels"),
        ("conv3d_rows", 1, 128, 2, 32, "none", "channels"),
        ("conv3d_rows_stride2", 1, 128, 32, 64, "scalar", "dense"),
        ("conv3d_rows_stride2", 1, 128, 32, 64, "scalar", "concat"),
        ("transpconv2_rows", 1, 64, 64, 32, None, "dense"),
        ("transpconv2_rows", 1, 64, 64, 32, None, "concat"),
    ]
    out = []
    for name, n, s, cin, cout, slope_kind, layout in cases:
        shape = (n, s, s, s, cin)
        x = torch.tensor(rng.normal(size=shape), dtype=torch.bfloat16, device=dev)
        sentinel_ok = None
        if name == "transpconv2_rows":
            w = torch.tensor(rng.normal(size=(2, 2, 2, cin, cout)) * 0.1,
                             dtype=torch.bfloat16, device=dev)
            b = None
            kw = {}
            if layout == "concat":
                b = torch.tensor(rng.normal(size=cout), dtype=torch.bfloat16, device=dev)
                cat = torch.full((n, 2 * s, 2 * s, 2 * s, 2 * cout), 7.0,
                                 dtype=torch.bfloat16, device=dev)
                kw["out"] = cat[..., :cout]
            launch, y = rc.prepare_launch(name, x, w, b, **kw)
            wrapper = lambda: rc.transpconv2_rows(x, w, b, **kw)  # noqa: E731
            plain = lambda: rc.transpconv2_rows_plain(x, w, b)  # noqa: E731
            wt = w.permute(3, 4, 0, 1, 2).contiguous()  # (ci, co, kx, ky, kz)
            lib = lambda: F.conv_transpose3d(x.permute(0, 4, 1, 2, 3), wt, b,  # noqa: E731
                                             stride=2)
            launch()
            torch.cuda.synchronize()
            yr = plain()
            err = float((y.float() - yr.float()).abs().max())
            ok = bool(torch.allclose(y.float(), yr.float(), rtol=2e-2, atol=2e-2))
            if layout == "concat":   # the channels K3 does not own are untouched
                sentinel_ok = bool(torch.equal(
                    _bits(torch, cat[..., cout:]),
                    _bits(torch, torch.full_like(cat[..., cout:], 7.0))))
                ok = ok and sentinel_ok
            rel_sums = None
            vox_out = n * (2 * s) ** 3
            nbytes = (x.numel() * 2 + w.numel() * 2 + (cout * 2 if b is not None else 0)
                      + vox_out * cout * 2)
            flops = 2.0 * n * s ** 3 * cin * 8 * cout
        else:
            stride = 2 if name == "conv3d_rows_stride2" else 1
            w = torch.tensor(rng.normal(size=(3, 3, 3, cin, cout)) * (1.0 / (27 * cin) ** 0.5),
                             dtype=torch.bfloat16, device=dev)
            b = torch.tensor(rng.normal(size=cout) * 0.1, dtype=torch.bfloat16, device=dev)
            if slope_kind == "none":
                norm, slope = rc.identity_normact(cin, dev), 1.0
            else:
                norm = _norm(torch, rc, rng, n, cin, dev)
                slope = (torch.cat([torch.ones(cin // 2, device=dev),
                                    torch.full((cin - cin // 2,), 0.01, device=dev)])
                         if slope_kind == "vector" else 0.01)
            xk, kw = x, {}
            if layout == "concat" and stride == 2:   # x: the concat's last cin channels
                cat = torch.tensor(rng.normal(size=shape[:4] + (2 * cin,)),
                                   dtype=torch.bfloat16, device=dev)
                cat[..., cin:] = x
                xk = cat[..., cin:]
            elif layout == "concat":   # y into the concat's last cout channels
                cat = torch.full(shape[:4] + (2 * cout,), 7.0, dtype=torch.bfloat16,
                                 device=dev)
                kw["out"] = cat[..., cout:]
            fn = rc.conv3d_rows if stride == 1 else rc.conv3d_rows_stride2
            pfn = rc.conv3d_rows_plain if stride == 1 else rc.conv3d_rows_stride2_plain
            launch, (y, sums) = rc.prepare_launch(name, xk, norm, w, b, slope=slope, **kw)
            wrapper = lambda: fn(xk, norm, w, b, slope=slope, **kw)  # noqa: E731
            plain = lambda: pfn(xk, norm, w, b, slope=slope)  # noqa: E731
            wt = w.permute(4, 3, 0, 1, 2).contiguous()
            lib = lambda: F.conv3d(x.permute(0, 4, 1, 2, 3), wt, b,  # noqa: E731
                                   stride=stride, padding=1)
            launch()
            torch.cuda.synchronize()
            yr, sr = plain()
            err = float((y.float() - yr.float()).abs().max())
            rel_sums = float((sums - sr).abs().max() / sr[:, 1].abs().max())
            ok = bool(torch.allclose(y.float(), yr.float(), rtol=2e-2, atol=2e-2)) \
                and rel_sums <= 1e-2
            if "out" in kw:   # the concat's first cout channels are untouched
                sentinel_ok = bool(y.data_ptr() == cat[..., cout:].data_ptr()) and bool(
                    torch.equal(_bits(torch, cat[..., :cout]),
                                _bits(torch, torch.full_like(cat[..., :cout], 7.0))))
                ok = ok and sentinel_ok
            so = s // stride
            nbytes = (x.numel() * 2 + w.numel() * 2 + cout * 2 + n * 4 * cin * 4
                      + n * so ** 3 * cout * 2 + n * 2 * cout * 4)
            flops = 2.0 * n * so ** 3 * 27 * cin * cout
        torch.cuda.synchronize()
        bytes_ms, ops_ms = bound(nbytes, flops)
        case = {"name": name, "n": n, "spatial": s, "cin": cin, "cout": cout,
                "slope": slope_kind, "layout": layout,
                "splits": getattr(launch, "split", None), "max_abs_err": err,
                "rel_err_sums": rel_sums, "sentinel_untouched": sentinel_ok,
                "kernel_ms": time_ms(torch, launch, 20),
                "wrapper_ms": time_ms(torch, wrapper, 10),
                "plain_ms": time_ms(torch, plain, 3),
                "library_ms": time_ms(torch, lib, 10),
                "bytes_ms": bytes_ms, "ops_ms": ops_ms, "ok": ok}
        out.append(case)
        del x, w, y, launch
        cat = xk = kw = None
        torch.cuda.empty_cache()
    emit({"phase": "kernels", "cases": out})
    bad = [c for c in out if not c["ok"]]
    if bad:
        raise AssertionError(f"kernel disagrees with its plain version: {bad}")
    return out


def _total_fast_model(torch, seed: int, head_bias: bool):
    from boa_tpu_torch.plans.plans import synthetic_plans
    from boa_tpu_torch.weights.convert import params_from_numpy
    from boa_tpu_torch.weights.store import init_params_numpy

    cfg = synthetic_plans(num_classes=118, patch_size=(128, 128, 128),
                          features=TOTAL_FAST_FEATURES).arch_config()
    params = init_params_numpy(cfg, seed)
    if head_bias:
        head = params["seg_heads"][-1]
        head["b"] = head["b"] + np.random.default_rng(7).normal(
            0, 3.0, head["b"].shape).astype(np.float32)
    return params_from_numpy(params, cfg, "cuda")


def phase_forward(torch, rc) -> dict:
    from boa_tpu_torch.models.unet import cast_model

    res = {}
    x = torch.tensor(np.random.default_rng(3).normal(size=(1, 128, 128, 128, 1)),
                     dtype=torch.bfloat16, device="cuda")
    with torch.no_grad():
        for label, head_bias in (("head_bias", True), ("plain_init", False)):
            model = cast_model(_total_fast_model(torch, 297, head_bias), torch.bfloat16)
            got = model(x, rc.KERNELS).float()
            ref = model(x, rc.PLAIN).float()
            assert got.shape == (1, 128, 128, 128, 118) and bool(torch.isfinite(got).all())
            res[label] = {
                "argmax_agree": float((got.argmax(-1) == ref.argmax(-1)).float().mean()),
                "max_abs_err": float((got - ref).abs().max()),
                "logit_absmax": float(ref.abs().max())}
            if head_bias:
                res["ms_per_tile_kernels"] = time_ms(torch, lambda: model(x, rc.KERNELS), 5)
                res["ms_per_tile_plain_composite"] = time_ms(torch, lambda: model(x, rc.PLAIN), 3)
                res["ms_per_tile_eager_cudnn"] = time_ms(torch, lambda: model.forward_eager(x), 5)
            del model, got, ref
            torch.cuda.empty_cache()
    emit({"phase": "forward", **res})
    if res["head_bias"]["argmax_agree"] <= 0.99:
        raise AssertionError(f"forward argmax agreement {res['head_bias']}")
    return res


def phase_fused(torch, rc, pc, profile_run: bool = False) -> tuple[list[dict], dict]:
    """K5 against its plain version at the 17 convs of the fused forward,
    then the full-width fused forward (with `profile_run`, one more under
    torch.profiler)."""
    import torch.nn.functional as F

    from boa_tpu_torch.models.unet import cast_model
    from boa_tpu_torch.models.unet_fused import pack_unet_params, unet_forward_fused

    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    cases = []
    for s, cin, cout, pending in FUSED_CONVS:
        x = torch.tensor(rng.normal(size=(s, s, s, cin)), dtype=torch.bfloat16, device=dev)
        w = torch.tensor(rng.normal(size=(3, 3, 3, cin, cout)) * (1.0 / (27 * cin) ** 0.5),
                         dtype=torch.bfloat16, device=dev)
        b = torch.tensor(rng.normal(size=cout) * 0.1, dtype=torch.bfloat16, device=dev)
        if pending:
            norm = _norm(torch, pc, rng, 1, cin, dev)
            norm, slope = norm._replace(mean=norm.mean[0], inv_std=norm.inv_std[0]), 0.01
        else:
            norm, slope = pc.identity_normact(cin, dev), 1.0
        kern, (y, sums) = pc.prepare_launch(x, norm, None, b, slope=slope,
                                            w_packed=pc.pack_in_act_weights(w),
                                            cin=cin, cout=cout)
        wrapper = lambda: pc.conv3d_in_act(x, norm, w, b, slope=slope)  # noqa: E731
        plain = lambda: pc.conv3d_in_act_plain(x, norm, w, b, slope=slope)  # noqa: E731
        wt = w.permute(4, 3, 0, 1, 2).contiguous()
        lib = lambda: F.conv3d(x[None].permute(0, 4, 1, 2, 3), wt, b, padding=1)  # noqa: E731
        kern()
        torch.cuda.synchronize()
        yr, sr = plain()
        err = float((y.float() - yr.float()).abs().max())
        rel_sums = float((sums - sr).abs().max() / sr[1].abs().max())
        ok = bool(torch.allclose(y.float(), yr.float(), rtol=2e-2, atol=2e-2)) \
            and rel_sums <= 1e-2 and y.shape == (s, s, s, cout)
        nbytes = (x.numel() * 2 + w.numel() * 2 + cout * 2 + 4 * cin * 4
                  + s ** 3 * cout * 2 + 2 * cout * 4)
        bytes_ms, ops_ms = bound(nbytes, 2.0 * s ** 3 * 27 * cin * cout)
        splits, taps = kern.split
        _, _, bn, cout_p = pc._plan(cin, cout)
        cases.append({"name": "conv3d_in_act", "spatial": s, "cin": cin, "cout": cout,
                      "pending_norm": pending, "splits": splits, "taps": taps,
                      "blocks": splits * pc._blocks(s, s, s, bn, cout_p),
                      "max_abs_err": err,
                      "rel_err_sums": rel_sums,
                      "kernel_ms": time_ms(torch, kern, 10),
                      "wrapper_ms": time_ms(torch, wrapper, 10),
                      "plain_ms": time_ms(torch, plain, 3),
                      "library_ms": time_ms(torch, lib, 10),
                      "bytes_ms": bytes_ms, "ops_ms": ops_ms, "ok": ok})
        del x, w, y, yr, kern
        torch.cuda.empty_cache()
    bad = [c for c in cases if not c["ok"]]
    if bad:
        emit({"phase": "fused", "cases": cases})
        raise AssertionError(f"K5 disagrees with its plain version: {bad}")
    # split-K at 16^3 and below, where a call is too small for the card;
    # never at 128^3
    unsplit = [c for c in cases if (c["spatial"] <= 16 and c["splits"] == 1)
               or (c["spatial"] == 128 and c["splits"] > 1)]
    if unsplit:
        emit({"phase": "fused", "cases": cases})
        raise AssertionError(f"K5 split plan: {unsplit}")

    res = {}
    xb = torch.tensor(np.random.default_rng(3).normal(size=(1, 128, 128, 128, 1)),
                      dtype=torch.bfloat16, device=dev)
    x = xb[0]
    with torch.no_grad():
        model = cast_model(_total_fast_model(torch, 297, True), torch.bfloat16)
        packed = pack_unet_params(model)
        pc.reset_launches()
        rc.reset_launches()
        got = unet_forward_fused(model, packed, x).float()
        torch.cuda.synchronize()
        res["launches"] = pc.LAUNCHES["conv3d_in_act"]
        res["finish_launches"] = pc.LAUNCHES["conv3d_in_act_finish"]
        res["rowconv_launches"] = dict(rc.LAUNCHES)
        plain = unet_forward_fused(model, packed, x, conv=pc.conv3d_in_act_plain).float()
        eager = model.forward_eager(xb)[0].float()
        assert got.shape == (128, 128, 128, 118) and bool(torch.isfinite(got).all())
        res.update(
            argmax_agree_plain=float((got.argmax(-1) == plain.argmax(-1)).float().mean()),
            argmax_agree_eager=float((got.argmax(-1) == eager.argmax(-1)).float().mean()),
            max_abs_err_plain=float((got - plain).abs().max()),
            logit_absmax=float(plain.abs().max()))
        del got, plain, eager
        res["ms_per_tile_fused"] = time_ms(torch, lambda: unet_forward_fused(model, packed, x), 5)
        res["ms_per_tile_fused_plain"] = time_ms(
            torch, lambda: unet_forward_fused(model, packed, x, conv=pc.conv3d_in_act_plain), 2)
        res["ms_per_tile_composite"] = time_ms(torch, lambda: model(xb, rc.KERNELS), 5)
        res["ms_per_tile_eager_cudnn"] = time_ms(torch, lambda: model.forward_eager(xb), 5)
        if profile_run:
            res["profile"] = _profile(torch, lambda: unet_forward_fused(model, packed, x))
        del model, packed
        torch.cuda.empty_cache()
    emit({"phase": "fused", "cases": cases, **res})
    if (res["launches"] != len(FUSED_CONVS) or any(res["rowconv_launches"].values())
            or res["finish_launches"] != sum(c["splits"] > 1 for c in cases)):
        raise AssertionError(f"fused forward launches {res}")
    if res["argmax_agree_plain"] <= 0.99 or res["argmax_agree_eager"] <= 0.98:
        raise AssertionError(f"fused forward argmax agreement {res}")
    return cases, res


def _bench_ct(shape, spacing):
    """The bench's synthetic anatomy: air, a soft-tissue ellipse, a dense
    core and mild noise."""
    from boa_tpu_torch.io.nifti import NiftiImage

    rng = np.random.default_rng(0)
    gx = np.linspace(-1, 1, shape[0], dtype=np.float32)[:, None]
    gy = np.linspace(-1, 1, shape[1], dtype=np.float32)[None, :]
    body = (gx ** 2 / 0.49 + gy ** 2 / 0.36) < 1.0
    core = (gx ** 2 / 0.04 + gy ** 2 / 0.04) < 1.0
    base = np.where(body, 40.0, -1000.0).astype(np.float32)
    base += np.where(core, 660.0, 0.0).astype(np.float32)
    vol = base[:, :, None] + 12.0 * rng.standard_normal(shape, dtype=np.float32)
    affine = np.diag([-spacing[0], -spacing[1], spacing[2], 1.0])
    affine[:3, 3] = (200.0, 180.0, -400.0)
    return NiftiImage(data=vol.astype(np.int16), affine=affine)


def _synthetic(tmp, task_id: int, name: str, trainer: str, num_classes: int,
               features, patch, spacing, label_names=None,
               background_lead: float | None = None) -> None:
    """A synthetic model folder with the bench's trick for coherent regions
    from random weights: the seg head biased with N(0, 3) from seed
    7 (+ the task id for the sub-models of `total` and the crop task). With
    `background_lead`, background's bias then leads the largest other by it,
    so that a sub-model of `total` predicts background in places and leaves
    room to the ones merged before it, as trained sub-models do."""
    from boa_tpu_torch.weights import convert as cv
    from boa_tpu_torch.weights.store import create_synthetic_model

    mdir = create_synthetic_model(
        tmp, task_id, name, num_classes=num_classes, trainer=trainer,
        patch_size=patch, spacing=spacing, features=features,
        label_names=label_names)
    path = mdir / "fold_0" / "checkpoint_final.npz"
    p0 = cv.load_params_npz(path)
    head = p0["seg_heads"][-1]
    seed = 7 if task_id == 297 else 7 + task_id
    head["b"] = head["b"] + np.asarray(np.random.default_rng(seed).normal(
        0, 3.0, head["b"].shape), head["b"].dtype)
    if background_lead is not None:
        head["b"][0] = head["b"][1:].max() + background_lead
    # uncompressed: random weights do not deflate, and the store reads them
    # back at every first load
    arrays: dict = {}
    cv._flatten(p0, "", arrays)
    np.savez(path, **arrays)


def _store(tmp, features, patch, label_names):
    """The synthetic `total_fast` model (task 297) in a store."""
    from boa_tpu_torch.weights.store import ModelStore

    _synthetic(tmp, 297, "TotalSegmentator_total_3mm_1559subj",
               "nnUNetTrainer_4000epochs_NoMirroring", len(label_names), features,
               patch, (3.0, 3.0, 3.0), label_names)
    return ModelStore(tmp)


def _profile(torch, run) -> dict:
    """One run under torch.profiler: device busy share and the kernels that
    take the most device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    from torch.autograd import DeviceType

    rows = []
    for ev in prof.key_averages():   # kernels only: op rows repeat their time
        if ev.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = ev.self_cuda_time_total
        rows.append((dev_us / 1e3, ev.count, ev.key[:90]))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows)
    return {"wall_ms": wall * 1e3, "device_busy_ms": busy_ms,
            "device_idle_share": max(0.0, 1.0 - busy_ms / (wall * 1e3)),
            "top": [{"ms": r[0], "calls": r[1], "name": r[2]} for r in rows[:15]]}


def _want_launches(tiles: int, rows_finish: int = 0) -> dict:
    """The composite's launches for `tiles` tile forwards: K1 four times, K2
    and K3 once each, no K5, and `rows_finish` finishing passes of K1's
    split calls (`_rows_finish`)."""
    return {"conv3d_rows": 4 * tiles, "conv3d_rows_finish": rows_finish,
            "conv3d_rows_stride2": tiles, "transpconv2_rows": tiles,
            "conv3d_in_act": 0, "conv3d_in_act_finish": 0}


def _rows_finish(torch, pc, tiles: int, patch, width: int) -> int:
    """K1's finishing launches for `tiles` one-tile forwards: one for each of
    a tile's three wide calls (width -> width, 2 width -> width, width ->
    width) that `pallas_conv._split_plan` splits at the patch; the 1-channel
    input conv never splits. None at 128^3, three at 32^3 on an H100."""
    sms = pc._sms(torch.device("cuda"))
    return tiles * sum(pc._split_plan(*patch, cin, width, sms)[0] > 1
                       for cin in (width, 2 * width, width))


def phase_study(torch, rc, pc, profile_run: bool = False) -> dict:
    from boa_tpu_torch.inference.pipeline import predict_image
    from boa_tpu_torch.tasks.class_maps import get_class_map

    label_names = ["background"] + list(get_class_map("total").values())
    res = {}

    # --- small study: card (kernels) against the CPU (plain versions)
    with tempfile.TemporaryDirectory() as tmp:
        store = _store(tmp, (32, 64, 128), (32, 32, 32), label_names)
        img = _bench_ct((96, 96, 64), (1.5, 1.5, 3.0))
        rc.reset_launches()
        pc.reset_launches()
        gpu = predict_image(img, "total", store, fast=True, device="cuda").seg.data
        launches_small = dict(rc.LAUNCHES, **pc.LAUNCHES)
        cpu = predict_image(img, "total", store, fast=True, device="cpu").seg.data
        res["small_agree"] = float((gpu == cpu).mean())
        res["small_launches"] = launches_small
        assert gpu.shape == img.shape and min(launches_small[k] for k in REPLACES
                                              if k != "conv3d_in_act") > 0
        assert launches_small["conv3d_in_act"] == 0, launches_small
        assert res["small_agree"] > 0.99, res

    # --- the 512x512x300 fast-total study
    shape, spacing = (512, 512, 300), (1.5, 1.5, 3.0)
    with tempfile.TemporaryDirectory() as tmp:
        store = _store(tmp, TOTAL_FAST_FEATURES, (128, 128, 128), label_names)
        img = _bench_ct(shape, spacing)
        times, runs = [], []
        torch.cuda.reset_peak_memory_stats()
        for i in range(4):
            spans: dict = {}
            rc.reset_launches()
            pc.reset_launches()
            t0 = time.perf_counter()
            r = predict_image(img, "total", store, fast=True, spans=spans)
            dt = time.perf_counter() - t0
            launches = dict(rc.LAUNCHES, **pc.LAUNCHES)
            tiles = spans["tiles"]
            want = _want_launches(tiles)
            assert tiles > 0 and launches == want, (launches, want)
            seg = r.seg.data
            assert seg.shape == shape and seg.dtype == np.uint8
            assert int(seg.max()) <= 117 and len(np.unique(seg)) > 1
            runs.append({"s": dt, "spans": spans, "launches": launches})
            if i > 0:
                times.append(dt)
        res.update(
            sec_min=min(times), sec_median=statistics.median(times),
            warmup_s=runs[0]["s"], tiles=tiles,
            model_grid=list(r.seg_model_grid.shape),
            labels_present=int(len(np.unique(seg))),
            peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
            spans=runs[-1]["spans"], launches=runs[-1]["launches"])
        if profile_run:
            res["profile"] = _profile(torch, lambda: predict_image(
                img, "total", store, fast=True))
    emit({"phase": "study", **res})
    return res


class _CountingStore:
    """A ModelStore that counts its checkpoint loads (the device weight
    cache should load each sub-model once across runs)."""

    def __init__(self, root) -> None:
        from boa_tpu_torch.weights.store import ModelStore

        self.inner, self.loads = ModelStore(root), 0
        self.root = self.inner.root

    def model_dir(self, *a, **kw):
        return self.inner.model_dir(*a, **kw)

    def load(self, *a, **kw):
        self.loads += 1
        return self.inner.load(*a, **kw)


def _parts_store(tmp, features, patch, spacing) -> "_CountingStore":
    """The five synthetic sub-models 291-295 of `total`, heads of
    max(part) + 1 classes."""
    from boa_tpu_torch.tasks import class_maps

    for tid in PART_IDS:
        part = class_maps.class_map_5_parts[class_maps.map_taskid_to_partname[tid]]
        _synthetic(tmp, tid, f"TotalSegmentator_part{tid}", "nnUNetTrainerNoMirroring",
                   max(part) + 1, features, patch, spacing,
                   background_lead=BACKGROUND_LEAD)
    return _CountingStore(tmp)


_SHARED_STORES: dict = {}


def _shared_parts_store(features, patch) -> "_CountingStore":
    """`_parts_store` at 1.5 mm, written once per run of this script (its
    folder lives until the script exits) and shared by the total and
    measure phases: a full-width store takes a minute to write. Its load
    count covers every phase that used it."""
    key = (tuple(features), tuple(patch))
    if key not in _SHARED_STORES:
        folder = tempfile.TemporaryDirectory()
        _SHARED_STORES[key] = (folder, _parts_store(folder.name, features, patch,
                                                    (1.5, 1.5, 1.5)))
    return _SHARED_STORES[key][1]


def _parts_of(seg) -> list[str]:
    """The sub-models (parts) whose labels appear in a `total` label volume."""
    from boa_tpu_torch.tasks import class_maps

    names = {class_maps.get_class_map("total")[int(v)] for v in np.unique(seg) if v}
    return sorted(p for p in (class_maps.map_taskid_to_partname[t] for t in PART_IDS)
                  if names & set(class_maps.class_map_5_parts[p].values()))


def phase_total(torch, rc, pc, profile_run: bool = False) -> dict:
    """`predict_image(img, "total", store)` without `fast`: five sub-models
    at 1.5 mm merged on the card. (a) small widths, card against the CPU;
    (b) a crop task through the predictor's own resample (its general
    path), card against the CPU; (c) the 512x512x300 study at the
    total_fast widths: one warm-up and two timed runs (with `profile_run`,
    one more under the profiler)."""
    from boa_tpu_torch.inference.pipeline import predict_image
    from boa_tpu_torch.io.nifti import NiftiImage
    from boa_tpu_torch.ops import cropping
    from boa_tpu_torch.ops import preprocess as pp
    from boa_tpu_torch.tasks.class_maps import get_class_map
    from boa_tpu_torch.tasks.registry import get_task

    total_labels = set(get_class_map("total"))
    res = {}

    def launches() -> dict:
        return dict(rc.LAUNCHES, **pc.LAUNCHES)

    def reset() -> None:
        rc.reset_launches()
        pc.reset_launches()

    # --- (a) small total, card against the CPU
    with tempfile.TemporaryDirectory() as tmp:
        store = _parts_store(tmp, (32, 64, 128), (32, 32, 32), (1.5, 1.5, 1.5))
        img = _bench_ct((96, 96, 64), (1.5, 1.5, 3.0))
        spans: dict = {}
        reset()
        gpu = predict_image(img, "total", store, device="cuda", spans=spans).seg.data
        got = launches()
        cpu = predict_image(img, "total", store, device="cpu").seg.data
        res["small"] = {"agree": float((gpu == cpu).mean()), "tiles": spans["tiles"],
                        "launches": got, "parts": _parts_of(gpu),
                        "labels_present": int(len(np.unique(gpu)))}
        emit({"phase": "total", "part": "small", **res["small"]})
        assert gpu.shape == img.shape and set(np.unique(gpu)) - {0} <= total_labels
        want = _want_launches(spans["tiles"], _rows_finish(torch, pc, spans["tiles"],
                                                           (32, 32, 32), 32))
        assert got == want, (got, want)
        assert res["small"]["agree"] > 0.99 and len(res["small"]["parts"]) >= 3, res

    # --- (b) the general predictor path: liver_vessels (task 8, 3 classes,
    #     1 mm plan) on a liver-sized crop box
    with tempfile.TemporaryDirectory() as tmp:
        from boa_tpu_torch.weights.store import ModelStore

        _synthetic(tmp, 8, "liver_vessels", "nnUNetTrainer", 3, (32, 64, 128),
                   (32, 32, 32), (1.0, 1.0, 1.0))
        store = ModelStore(tmp)
        img = _bench_ct((96, 96, 64), (1.5, 1.5, 3.0))
        mask = np.zeros(img.shape, np.uint8)
        mask[24:64, 28:60, 16:40] = 1
        crop = NiftiImage(data=mask, affine=img.affine.copy())
        spans = {}
        reset()
        gpu = predict_image(img, "liver_vessels", store, crop_mask=crop,
                            device="cuda", spans=spans).seg.data
        got = launches()
        cpu = predict_image(img, "liver_vessels", store, crop_mask=crop,
                            device="cpu").seg.data
        res["crop"] = {"agree": float((gpu == cpu).mean()), "tiles": spans["tiles"],
                       "launches": got, "labels": sorted(int(v) for v in np.unique(gpu))}
        emit({"phase": "total", "part": "crop", **res["crop"]})
        box = cropping.get_bbox_from_mask(mask, addon=(np.array(
            get_task("liver_vessels").crop_addon) / np.array(img.zooms)).astype(int))
        inside = np.zeros(mask.shape, bool)
        inside[tuple(slice(a, b) for a, b in box)] = True
        assert gpu.shape == img.shape and not gpu[~inside].any()
        want = _want_launches(spans["tiles"], _rows_finish(torch, pc, spans["tiles"],
                                                           (32, 32, 32), 32))
        assert got == want and got["conv3d_rows"] > 0, (got, want)
        assert res["crop"]["agree"] > 0.99, res["crop"]

    # --- (c) the 512x512x300 study at the total_fast widths
    shape, spacing = (512, 512, 300), (1.5, 1.5, 3.0)
    store = _shared_parts_store(TOTAL_FAST_FEATURES, (128, 128, 128))
    img = _bench_ct(shape, spacing)
    times, runs = [], []
    torch.cuda.reset_peak_memory_stats()
    for i in range(3):
        spans = {}
        reset()
        t0 = time.perf_counter()
        r = predict_image(img, "total", store, spans=spans)
        dt = time.perf_counter() - t0
        got = launches()
        grid = tuple(r.seg_model_grid.shape)
        per_model = len(pp.tile_starts(tuple(max(n, 128) for n in grid),
                                       (128, 128, 128), 0.8))
        assert spans["tiles"] == len(PART_IDS) * per_model, (spans, per_model)
        assert got == _want_launches(spans["tiles"]), got
        seg = r.seg.data
        assert seg.shape == shape and seg.dtype == np.uint8
        assert set(np.unique(seg)) - {0} <= total_labels
        runs.append({"s": dt, "spans": spans, "launches": got})
        if i > 0:
            times.append(dt)
    res["study"] = {
        "sec_min": min(times), "sec_median": statistics.median(times),
        "timed_runs": len(times), "warmup_s": runs[0]["s"],
        "model_grid": list(grid), "tiles_per_submodel": per_model,
        "tiles": spans["tiles"],
        # sub-models whose predictor accumulated in float16 (last run)
        "float16_accumulators": spans["float16_accumulators"],
        "checkpoint_loads": store.loads,
        "labels_present": int(len(np.unique(seg))), "parts": _parts_of(seg),
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "spans": runs[-1]["spans"], "launches": runs[-1]["launches"],
        "seconds_all": [x["s"] for x in runs]}
    assert store.loads == len(PART_IDS), store.loads
    if profile_run:
        res["study"]["profile"] = _profile(
            torch, lambda: predict_image(img, "total", store))
    emit({"phase": "total", "part": "study", **res["study"]})

    # --- (d) the general predictor path at full width: liver_vessels at the
    #     total_fast widths (128^3 patch, 1 mm plan) on a liver-sized box of
    #     the 512x512x300 CT, against the same run on the plain composite
    res["crop_full"] = _crop_full(torch, rc, pc, img)
    emit({"phase": "total", "part": "crop_full", **res["crop_full"]})
    return res


def _crop_full(torch, rc, pc, img) -> dict:
    """(d) of the total phase: one warm-up and one timed run of
    `predict_image(img, "liver_vessels", store, crop_mask=...)` with
    full-width weights (seconds, spans, peak memory, launches), then one run
    with the cached models' forward switched to the plain versions of
    K1-K3 (`rc.PLAIN`) on the card: labels agree > 0.99."""
    from boa_tpu_torch.inference.pipeline import predict_image
    from boa_tpu_torch.inference.predictor import load_stacked_cached
    from boa_tpu_torch.io.nifti import NiftiImage
    from boa_tpu_torch.models.unet import PlainConvUNet
    from boa_tpu_torch.ops import cropping
    from boa_tpu_torch.tasks.registry import get_task
    from boa_tpu_torch.weights.store import ModelStore

    class PlainComposite(PlainConvUNet):
        """The composite forward on the plain versions of its kernels."""

        def forward(self, x, ops=rc.PLAIN):
            return super().forward(x, ops)

    task = get_task("liver_vessels")
    # about 200 x 160 x 170 mm, the liver's extent in an adult CT
    mask = np.zeros(img.shape, np.uint8)
    mask[190:323, 200:307, 120:177] = 1
    crop = NiftiImage(data=mask, affine=img.affine.copy())
    with tempfile.TemporaryDirectory() as tmp:
        _synthetic(tmp, 8, "liver_vessels", task.trainer, 3, TOTAL_FAST_FEATURES,
                   (128, 128, 128), (1.0, 1.0, 1.0))
        store = ModelStore(tmp)
        seconds = []
        for _ in range(2):
            spans: dict = {}
            torch.cuda.synchronize()
            resident = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            rc.reset_launches()
            pc.reset_launches()
            t0 = time.perf_counter()
            seg = predict_image(img, "liver_vessels", store, crop_mask=crop,
                                spans=spans).seg.data
            seconds.append(time.perf_counter() - t0)
            got = dict(rc.LAUNCHES, **pc.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        _, models = load_stacked_cached(store, 8, task.trainer, task.model,
                                        task.folds, "cuda")
        for m in models:
            m.__class__ = PlainComposite
        rc.reset_launches()
        try:
            ref = predict_image(img, "liver_vessels", store, crop_mask=crop).seg.data
        finally:
            for m in models:
                m.__class__ = PlainConvUNet
        ref_launches = sum(rc.LAUNCHES.values())
    tiles = spans["tiles"]
    want = _want_launches(tiles, _rows_finish(torch, pc, tiles, (128, 128, 128),
                                              TOTAL_FAST_FEATURES[0]))
    box = cropping.get_bbox_from_mask(mask, addon=(np.array(task.crop_addon)
                                                   / np.array(img.zooms)).astype(int))
    inside = np.zeros(mask.shape, bool)
    inside[tuple(slice(a, b) for a, b in box)] = True
    out = {"agree_plain": float((seg == ref).mean()),
           "agree_plain_in_box": float((seg[inside] == ref[inside]).mean()),
           "sec": seconds[1], "warmup_s": seconds[0], "tiles": tiles,
           "box": [[int(a), int(b)] for a, b in box],
           "float16_accumulators": spans["float16_accumulators"],
           "resident_gib": resident / 2 ** 30, "peak_mem_gib": peak / 2 ** 30,
           "labels": sorted(int(v) for v in np.unique(seg)),
           "spans": spans, "launches": got}
    assert seg.shape == img.shape and not seg[~inside].any()
    assert got == want and tiles > 0, (got, want)
    assert ref_launches == 0, ref_launches   # the reference ran no kernel
    assert out["agree_plain_in_box"] > 0.99, out
    return out


# exact in both runs of the measurement engine: counts, volumes and every
# number read off a histogram; the masked moments (the autochthon's mean
# and std) and the CNRs derived from them within 1e-6 relative
_EXACT = ("present", "volume_ml", "mean_hu", "std_hu", "min_hu", "max_hu", "median_hu",
          "25th_percentile_hu", "75th_percentile_hu")


def _max_rel(a, b, path="") -> float:
    """Walk two measurement dicts of the same structure: fields in `_EXACT`,
    flags and Nones must be equal; returns the largest relative difference
    of the other numbers."""
    if isinstance(b, dict):
        if list(a) != list(b):
            raise AssertionError(f"measurement keys differ at {path}")
        return max([_max_rel(a[k], b[k], f"{path}/{k}") for k in b] + [0.0])
    if b is None or isinstance(b, bool) or path.rsplit("/", 1)[-1] in _EXACT:
        if a != b:
            raise AssertionError(f"measurement {path}: {a} != {b}")
        return 0.0
    return abs(a - b) / max(abs(b), 1e-300)


def _measure_volume(shape, spacing):
    """(CT, labels) for the measurement engine at `shape`: the bench CT;
    labels in 8^3 blocks of every `total` class over the body, then blocks of
    the autochthon (muscle HU), the aorta (contrast HU) and the five lung
    lobes (lung HU, fat HU in their first third), as tests/test_measurements.py
    lays them out at a small size. Box corners are given on 512x512x300 and
    scaled to `shape`."""
    from boa_tpu_torch.tasks.class_maps import get_class_map

    inv = {v: k for k, v in get_class_map("total").items()}
    ct = np.array(_bench_ct(shape, spacing).data)
    rng = np.random.default_rng(21)
    coarse = rng.integers(0, 118, tuple(-(-n // 8) for n in shape)).astype(np.uint8)
    seg = coarse.repeat(8, 0).repeat(8, 1).repeat(8, 2)[:shape[0], :shape[1], :shape[2]]
    seg = np.ascontiguousarray(seg)
    seg[ct < -500] = 0

    def paint(name, box, lo, hi, fat_share=0.0):
        box = tuple(slice(a * n // m, b * n // m)
                    for (a, b), n, m in zip(box, shape, (512, 512, 300)))
        seg[box] = inv[name]
        part = ct[box]
        part[...] = rng.integers(lo, hi, part.shape)
        nfat = int(part.shape[0] * fat_share)
        part[:nfat] = rng.integers(-200, -39, part[:nfat].shape)

    paint("autochthon_left", ((200, 250), (300, 380), (40, 260)), 20, 80)
    paint("autochthon_right", ((262, 312), (300, 380), (40, 260)), 20, 80)
    paint("aorta", ((240, 272), (200, 232), (20, 280)), 150, 350)
    for name, box in [
            ("lung_upper_lobe_left", ((140, 220), (130, 200), (200, 290))),
            ("lung_lower_lobe_left", ((140, 220), (130, 200), (150, 200))),
            ("lung_upper_lobe_right", ((300, 380), (130, 200), (230, 290))),
            ("lung_middle_lobe_right", ((300, 380), (130, 200), (190, 230))),
            ("lung_lower_lobe_right", ((300, 380), (130, 200), (150, 190)))]:
        paint(name, box, -900, -700, fat_share=1 / 3)
    return ct, seg


def phase_measure(torch, rc, pc, profile_run: bool = False) -> dict:
    """The measurement path. (a) `compute_all_models(ct_path, out, ["total"])`
    on the small five-model store at two stages (widths 32/64, 32^3 patch) from a
    96x96x32 `.nii.gz` written by the port's codec, on the card and on the
    CPU: every promised file exists and loads, labels agree > 0.99, launches
    tiles x (4, 1, 1) with the split plan's finishing passes; (b) the
    measurement engine at 512x512x300 (`get_basic_statistics` mean and
    median, `compute_measurements_arrays` with the CNR adjustment) on the
    card against the same calls on the CPU, with the seconds of each span;
    (c) the 512x512x300 study from its file to total.nii.gz, its statistics
    and total-measurements.json at the total_fast widths: one warm-up and
    one timed run (seconds, spans, peak memory, launches as the total
    phase's)."""
    import json
    from pathlib import Path

    from boa_tpu_torch.compute.inference import compute_all_models
    from boa_tpu_torch.io import nifti
    from boa_tpu_torch.measure import measurements as ms
    from boa_tpu_torch.measure.statistics import get_basic_statistics
    from boa_tpu_torch.ops import cropping
    from boa_tpu_torch.ops import preprocess as pp
    from boa_tpu_torch.ops import resample as rs
    from boa_tpu_torch.tasks.class_maps import get_class_map

    total_map = get_class_map("total")
    promised = ("total.nii.gz", "ct_pfav.nii.gz", "total-statistics.json",
                "total-measurements.json")
    res = {}

    def launches() -> dict:
        return dict(rc.LAUNCHES, **pc.LAUNCHES)

    def reset() -> None:
        rc.reset_launches()
        pc.reset_launches()

    def outputs(folder: Path, shape) -> dict:
        """Every promised file loads; the labels and the JSONs make sense."""
        seg = nifti.load(folder / "total.nii.gz").data
        pfav = nifti.load(folder / "ct_pfav.nii.gz").data
        stats = json.loads((folder / "total-statistics.json").read_text())
        meas = json.loads((folder / "total-measurements.json").read_text())
        assert sorted(p.name for p in folder.iterdir()) == sorted(promised)
        assert seg.shape == pfav.shape == shape and seg.dtype == np.uint8
        assert set(np.unique(seg)) - {0} <= set(total_map) and set(np.unique(pfav)) <= {0, 1}
        assert list(stats) == list(total_map.values())
        assert set(meas["segmentations"]["total"]) >= set(total_map.values())
        return {"labels": seg, "labels_present": int(len(np.unique(seg))),
                "stats_nonzero": sum(v["volume"] > 0 for v in stats.values()),
                "regions_present": sum(m["present"] for m in
                                       meas["segmentations"]["total"].values())}

    # --- (a) small file-to-files run, card against the CPU
    t_part = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        store = _parts_store(tmp, SMALL_RUN_FEATURES, (32, 32, 32), (1.5, 1.5, 1.5))
        img = _bench_ct(SMALL_RUN_SHAPE, (1.5, 1.5, 3.0))
        nifti.save(img, tmp / "ct.nii.gz")
        spans: dict = {}
        reset()
        compute_all_models(tmp / "ct.nii.gz", tmp / "gpu", ["total"], store=store,
                           device="cuda", spans=spans)
        got = launches()
        compute_all_models(tmp / "ct.nii.gz", tmp / "cpu", ["total"], store=store,
                           device="cpu")
        gpu, cpu = outputs(tmp / "gpu", img.shape), outputs(tmp / "cpu", img.shape)
        want = _want_launches(spans["tiles"], _rows_finish(torch, pc, spans["tiles"],
                                                           (32, 32, 32), 32))
        res["small"] = {"agree": float((gpu.pop("labels") == cpu.pop("labels")).mean()),
                        "tiles": spans["tiles"], "launches": got, "gpu": gpu, "cpu": cpu,
                        "files": list(promised), "part_s": time.perf_counter() - t_part}
        emit({"phase": "measure", "part": "small", **res["small"]})
        assert got == want, (got, want)
        assert res["small"]["agree"] > 0.99, res["small"]

    # --- (b) the measurement engine at 512x512x300, card against the CPU
    t_part = time.perf_counter()
    shape, spacing = STUDY_SHAPE, (1.5, 1.5, 3.0)
    ct, seg = _measure_volume(shape, spacing)
    assert len(np.unique(seg)) == len(total_map) + 1   # every class is there
    dev = torch.device("cuda")
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    ct_dev, seg_dev = torch.from_numpy(ct).to(dev), torch.from_numpy(seg).to(dev)

    def engine(device):
        """The three calls on `device`, with their seconds and spans."""
        on_card = device == "cuda"
        kw = ({"ct_dev": ct_dev, "seg_devs": {"total": seg_dev}} if on_card
              else {"device": "cpu"})
        args = (seg_dev, ct_dev) if on_card else (seg, ct)
        out, sec, spans = {}, {}, {}
        for metric in ("mean", "median"):
            t0 = time.perf_counter()
            out[metric] = get_basic_statistics(*args, spacing, total_map, metric=metric,
                                               device=device)
            sec[f"statistics_{metric}"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["measurements"] = ms.compute_measurements_arrays(
            ct, {"total": seg}, spacing, cnr_adjustment=True, spans=spans, **kw)
        sec["measurements"] = time.perf_counter() - t0
        return out, sec, spans

    engine("cuda")   # warm-up: first launches of each kernel
    torch.cuda.reset_peak_memory_stats()
    gpu, gpu_sec, gpu_spans = engine("cuda")
    peak = torch.cuda.max_memory_allocated() - resident
    cpu, cpu_sec, cpu_spans = engine("cpu")
    meas = gpu["measurements"]
    res["engine"] = {
        "voxels": int(np.prod(shape)), "gpu_s": gpu_sec, "gpu_spans": gpu_spans,
        "cpu_s": cpu_sec, "cpu_spans": cpu_spans, "cpu_sub_box": False,
        "peak_mem_gib_with_inputs": peak / 2 ** 30,
        "masked_moment_max_rel": _max_rel(meas, cpu["measurements"]),
        "autochthon": meas["info"],
        "cnr_adjusted_ml": {k: v.get("volume_ml") for k, v in meas["cnr_adjusted"].items()},
        "regions_present": sum(m["present"] for m in meas["segmentations"]["total"].values())}
    if profile_run:
        res["engine"]["profile"] = _profile(torch, lambda: engine("cuda"))
    res["engine"]["part_s"] = time.perf_counter() - t_part
    emit({"phase": "measure", "part": "engine", **res["engine"]})
    for metric in ("mean", "median"):
        assert gpu[metric] == cpu[metric], metric   # volumes and intensities
    assert res["engine"]["masked_moment_max_rel"] <= 1e-6, res["engine"]
    assert meas["info"]["autochthon_mean"] is not None
    assert all(m["present"] for m in meas["cnr_adjusted"].values()), meas["cnr_adjusted"]
    assert meas["segmentations"]["total"]["ct_pfav_lungs"]["present"]
    del ct_dev, seg_dev

    # --- (c) the 512x512x300 study from its file, at the total_fast widths
    t_part = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        patch = (128, 128, 128)
        store = _shared_parts_store(TOTAL_FAST_FEATURES, patch)
        img = _bench_ct(shape, spacing)
        nifti.save(img, tmp / "ct.nii.gz")
        # the model grid: the body crop at 1.5 mm
        cut = nifti.canonical_geometry(cropping.body_crop_xy(img)[0])
        grid = rs.change_spacing_shape(cut[2], cut[3], (1.5, 1.5, 1.5))[0]
        grid_tiles = len(PART_IDS) * len(pp.tile_starts(
            tuple(max(n, p) for n, p in zip(grid, patch)), patch, 0.8))
        runs = []
        for i in range(2):
            spans = {}
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset()
            t0 = time.perf_counter()
            compute_all_models(tmp / "ct.nii.gz", tmp / f"out{i}", ["total"], store=store,
                               spans=spans)
            dt = time.perf_counter() - t0
            runs.append({"s": dt, "spans": spans, "launches": launches(),
                         "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30})
        out = outputs(tmp / "out1", shape)
        out.pop("labels")
        res["study"] = {"sec": runs[1]["s"], "warmup_s": runs[0]["s"],
                        "model_grid": [int(n) for n in grid],
                        "peak_mem_gib": runs[1]["peak_mem_gib"], "spans": runs[1]["spans"],
                        "launches": runs[1]["launches"], "tiles": spans["tiles"],
                        "checkpoint_loads": store.loads, **out,
                        "part_s": time.perf_counter() - t_part}
    emit({"phase": "measure", "part": "study", **res["study"]})
    for r in runs:
        assert r["spans"]["tiles"] == grid_tiles, (r["spans"]["tiles"], grid_tiles)
        assert r["launches"] == _want_launches(grid_tiles), r["launches"]
    assert store.loads == len(PART_IDS), store.loads
    return res


# --- phase 8: the BCA chain --------------------------------------------------

# (task id, name, model folder name, trainer) of the two BCA models
BCA_MODELS = ((543, "body_parts", "BCA_body_parts", "nnUNetTrainer_1500epochs_NoMirroring"),
              (542, "body_regions", "BCA_body_regions", "nnUNetTrainerNoMirroring"))
BCA_FOLDS = 5   # the registry runs folds 0-4
BCA_FILES = ("body_parts.nii.gz", "body_regions.nii.gz", "tissues.nii.gz",
             "bca-measurements.json")


def _bca_store(tmp, features, patch) -> None:
    """body_parts (543) and body_regions (542) in `tmp`, five folds each, at
    1.5 x 1.5 x 5 mm (x, y, z; the plans list it z first), so that the
    bench CT's model grid (its own 1.5 mm in plane, 5 mm in z) is the plans'
    grid and the predictor does not resample; every fold's head biased as
    `_synthetic` biases fold 0, with background's lead. The repo holds no
    published plans for tasks 542/543: they take the geometry given here.
    Eight threads write the folds (zlib releases the interpreter lock)."""
    from concurrent.futures import ThreadPoolExecutor

    from boa_tpu_torch.bca.definitions import BodyPart, BodyRegion
    from boa_tpu_torch.plans.plans import synthetic_plans
    from boa_tpu_torch.weights import convert as cv
    from boa_tpu_torch.weights.store import create_synthetic_model, init_params_numpy

    jobs = []
    for (tid, _, name, trainer), enum_ in zip(BCA_MODELS, (BodyPart, BodyRegion)):
        names = [e.name.lower() for e in sorted(enum_, key=int) if e]
        kw = dict(num_classes=len(names) + 1, patch_size=patch, spacing=(5.0, 1.5, 1.5),
                  features=features, label_names=names)
        mdir = create_synthetic_model(tmp, tid, name, trainer=trainer, n_folds=0, **kw)
        cfg = synthetic_plans(**kw).arch_config()
        jobs += [(mdir, cfg, tid, f) for f in range(BCA_FOLDS)]

    def write(job) -> None:
        mdir, cfg, tid, fold = job
        params = init_params_numpy(cfg, tid * 10 + fold)
        head = params["seg_heads"][-1]
        head["b"] = head["b"] + np.asarray(np.random.default_rng(7 + tid).normal(
            0, 3.0, head["b"].shape), head["b"].dtype)
        head["b"][0] = head["b"][1:].max() + BACKGROUND_LEAD
        (mdir / f"fold_{fold}").mkdir()
        cv.save_params_npz(params, mdir / f"fold_{fold}" / "checkpoint_final.npz")

    with ThreadPoolExecutor(8) as pool:
        list(pool.map(write, jobs))


def _bca_tiles(img, patch, total_spacing) -> dict:
    """Tiles per model of a `compute_all_models(["total", "bca"])` run on
    `img`: `total` (one sub-model at `total_spacing`, step 0.5, or the five
    at 1.5 mm, step 0.8, when `total_spacing` is None) and the two BCA models
    (the body crop's in-plane spacing, 5 mm in z, step 0.5)."""
    from boa_tpu_torch.io import nifti
    from boa_tpu_torch.ops import cropping
    from boa_tpu_torch.ops import preprocess as pp
    from boa_tpu_torch.ops import resample as rs

    cut = nifti.canonical_geometry(cropping.body_crop_xy(img)[0])

    def tiles(spacing, step) -> int:
        grid = rs.change_spacing_shape(cut[2], cut[3], spacing)[0]
        return len(pp.tile_starts(tuple(max(int(n), p) for n, p in zip(grid, patch)),
                                  patch, step))

    total = (len(PART_IDS) * tiles((1.5, 1.5, 1.5), 0.8) if total_spacing is None
             else tiles(total_spacing, 0.5))
    bca = tiles((cut[3][0], cut[3][1], 5.0), 0.5)
    return {"total": total, "bca_per_fold": bca,
            "tiles": total + 2 * bca,
            "tile_forwards": total + 2 * BCA_FOLDS * bca}


def _json_max_rel(a, b, path="") -> float:
    """Walk two JSON values: the same keys in the same order, and None,
    bools and strings in the same places, or raise; returns the largest
    relative difference of their numbers."""
    if isinstance(b, (dict, list)):
        keys = list(b) if isinstance(b, dict) else range(len(b))
        if type(a) is not type(b) or list(a if isinstance(b, dict) else range(len(a))) \
                != list(keys):
            raise AssertionError(f"structure differs at {path}")
        return max([_json_max_rel(a[k], b[k], f"{path}/{k}") for k in keys] + [0.0])
    if b is None or isinstance(b, (bool, str)) or a is None or isinstance(a, (bool, str)):
        if a != b:
            raise AssertionError(f"{path}: {a!r} != {b!r}")
        return 0.0
    return abs(a - b) / max(abs(b), 1e-300)


def _bca_phantom(shape, spacing):
    """(CT, parts, regions, vertebra windows) of the port's anatomy phantom:
    all six body parts (an arm in the body's outer eighth at each x end,
    the head in the top tenth of the slices, a leg in each x half of the
    bottom eighth, the torso between: the no-limb sums differ and the parts
    postprocess has six labels), and 255 fragments in 4^3 blocks over 1 %
    of the regions."""
    from boa_tpu_torch.bca.definitions import BodyPart
    from boa_tpu_torch.bca.report import AggregatableBodyPart, create_vertebrae_info
    from boa_tpu_torch.tasks.class_maps import get_class_map
    from boa_tpu_torch.testing import anatomy

    ct = anatomy.synth_ct(shape, spacing)
    parts = anatomy.fake_parts_seg(shape, spacing)
    body_x = np.flatnonzero(parts.any(axis=(1, 2)))
    x0, x1, nz = int(body_x[0]), int(body_x[-1]) + 1, shape[2]
    arm, mid = (x1 - x0) // 8, (x0 + x1) // 2
    for xs, zs, part in ((slice(x0, x0 + arm), slice(None), BodyPart.ARM_LEFT),
                         (slice(x1 - arm, x1), slice(None), BodyPart.ARM_RIGHT),
                         (slice(None), slice(nz - nz // 10, nz), BodyPart.HEAD),
                         (slice(None, mid), slice(0, nz // 8), BodyPart.LEG_LEFT),
                         (slice(mid, None), slice(0, nz // 8), BodyPart.LEG_RIGHT)):
        box = parts[xs, :, zs]
        box[box > 0] = int(part)
    regions = anatomy.fake_regions_seg(shape, spacing)
    rng = np.random.default_rng(8)
    coarse = rng.random(tuple(-(-n // 4) for n in shape)) < 0.01
    frag = coarse.repeat(4, 0).repeat(4, 1).repeat(4, 2)[:shape[0], :shape[1], :shape[2]]
    regions[frag & (regions > 0)] = 255
    vertebrae = create_vertebrae_info(
        anatomy.fake_total_seg(shape, spacing),
        AggregatableBodyPart.ABDOMEN | AggregatableBodyPart.THORAX, get_class_map("total"))
    return ct, parts, regions, vertebrae


def _parts_postprocess_ab(parts) -> dict:
    """Seconds of the host's parts postprocess on `parts` with one thread
    per label (as it runs) and with one thread (`os.cpu_count` pinned to
    1), in the order threads, one, one, threads; the four results must be
    equal."""
    from contextlib import nullcontext
    from unittest import mock

    from boa_tpu_torch.bca.postprocess import postprocess_part_segmentation

    secs: dict = {"threads": [], "one_thread": []}
    outs = []
    for mode in ("threads", "one_thread", "one_thread", "threads"):
        pin = mock.patch.object(os, "cpu_count", lambda: 1) if mode == "one_thread" \
            else nullcontext()
        with pin:
            t0 = time.perf_counter()
            outs.append(postprocess_part_segmentation(parts))
            secs[mode].append(time.perf_counter() - t0)
    assert all(np.array_equal(o, outs[0]) for o in outs[1:])
    secs["labels"] = int(len(np.unique(outs[0]))) - 1
    return secs


def _one_hot_alternatives(torch, ct, tissues, regions, torso) -> dict:
    """The report's three per-slice and per-axis passes (`torch.bincount`
    over a combined key) against a loop of one masked reduction per label id
    on the same tensors: CUDA-event ms of both, and whether they agree. The
    loops are used only here, to keep choosing between the two."""
    from boa_tpu_torch.bca import report

    n, nz = report._N_TISSUE, tissues.shape[2]

    def slicewise_loop():
        ctd = ct.to(torch.float64)
        counts = torch.empty((2, n, nz), dtype=torch.int64, device=tissues.device)
        husums = torch.empty((2, n, nz), dtype=torch.float64, device=tissues.device)
        for i in range(n):
            m = tissues == i
            mt = m & torso
            counts[0, i], counts[1, i] = m.sum(dim=(0, 1)), mt.sum(dim=(0, 1))
            husums[0, i] = torch.where(m, ctd, 0.0).sum(dim=(0, 1))
            husums[1, i] = torch.where(mt, ctd, 0.0).sum(dim=(0, 1))
        c, h = counts.transpose(1, 2).cpu().numpy(), husums.transpose(1, 2).cpu().numpy()
        return c[0], h[0], c[1], h[1]

    def region_loop(width=16):
        return torch.stack([(regions == i).sum(dim=(0, 1)) for i in range(width)],
                           dim=1).cpu().numpy()

    def density_loop(axis=1):
        counts = torch.stack([(tissues == i).sum(dim=axis) for i in range(1, n)])
        return (counts.to(torch.float32) / tissues.shape[axis]).cpu().numpy()

    port = {"slicewise": lambda: report._slicewise_pass(ct, tissues, torso),
            "region_z": lambda: report._region_z_pass(regions, 16),
            "density": lambda: report._tissue_density_pass(tissues, 1)}
    loops = {"slicewise": slicewise_loop, "region_z": region_loop, "density": density_loop}
    out = {"agree": {k: all(np.array_equal(a, b) for a, b in zip(port[k](), loops[k]()))
                     if k == "slicewise" else np.array_equal(port[k](), loops[k]())
                     for k in port}}
    for k in port:
        out[f"{k}_bincount_ms"] = time_ms(torch, port[k], 5)
        out[f"{k}_loop_ms"] = time_ms(torch, loops[k], 5)
    return out


def phase_bca(torch, rc, pc, timed: bool = True) -> dict:
    """The BCA chain. (a) `compute_all_models(ct_path, out, ["total", "bca"])`
    on small stores (the five sub-models of 6 (a), body_parts and
    body_regions with five folds, at two stages: widths 32/64, 32^3 patch) from a
    96x96x32 `.nii.gz`, on the card and on the CPU: every promised file
    exists and loads, labels agree > 0.99, bca-measurements.json has the
    same keys and Nones, launches tiles x folds x (4, 1, 1) with the split
    plan's finishing passes; (b) the BCA device passes at 512x512x300 on the
    anatomy phantom: `subclassify_tissues` with and without the median, the
    Builder, `region_z_counts`, `prepare` and `create_json` on the card
    against the CPU (tissues and counts equal, HU sums and the JSON within
    1e-9 relative), their seconds, spans and peak, the bincount passes
    against loops of masked reductions, and the host's parts postprocess
    with and without its threads; (c) the 512x512x300 study from its
    file through `compute_all_models(["total", "bca"])` with `total` fast
    and both BCA models at the total_fast widths with five folds: one
    warm-up and, with `timed`, one timed run (seconds, spans, peak,
    launches, each model loaded once). Without `timed` the cli phase's (c)
    times the same study through the CLI."""
    import json
    from pathlib import Path

    from boa_tpu_torch.bca.report import AggregatableBodyPart, Builder
    from boa_tpu_torch.bca.tissues import subclassify_tissues
    from boa_tpu_torch.compute.inference import compute_all_models
    from boa_tpu_torch.io import nifti

    params = {"save_pdf": False}
    res = {}

    def launches() -> dict:
        return dict(rc.LAUNCHES, **pc.LAUNCHES)

    def reset() -> None:
        rc.reset_launches()
        pc.reset_launches()

    def outputs(folder: Path, shape) -> dict:
        """Every label file and the BCA report load."""
        files = sorted(p.name for p in folder.iterdir())
        assert set(BCA_FILES) | {"total.nii.gz", "total-measurements.json"} <= set(files), files
        labels = {n: nifti.load(folder / n).data for n in files if n.endswith(".nii.gz")}
        for n, seg in labels.items():
            assert seg.shape == shape, (n, seg.shape)
        return {"files": files, "labels": labels,
                "report": json.loads((folder / "bca-measurements.json").read_text())}

    # --- (a) small file-to-files run, card against the CPU
    t_part = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        patch = (32, 32, 32)
        store = _parts_store(tmp, SMALL_RUN_FEATURES, patch, (1.5, 1.5, 1.5))
        _bca_store(tmp, SMALL_RUN_FEATURES, patch)
        img = _bench_ct(SMALL_RUN_SHAPE, (1.5, 1.5, 3.0))
        nifti.save(img, tmp / "ct.nii.gz")
        spans: dict = {}
        reset()
        compute_all_models(tmp / "ct.nii.gz", tmp / "gpu", ["total", "bca"], store=store,
                           bca_params=params, device="cuda", spans=spans)
        got = launches()
        compute_all_models(tmp / "ct.nii.gz", tmp / "cpu", ["total", "bca"], store=store,
                           bca_params=params, device="cpu")
        gpu, cpu = outputs(tmp / "gpu", img.shape), outputs(tmp / "cpu", img.shape)
        assert gpu["files"] == cpu["files"], (gpu["files"], cpu["files"])
        expect = _bca_tiles(img, patch, None)
        tf = spans["tile_forwards"]
        want = _want_launches(tf, _rows_finish(torch, pc, tf, patch, 32))
        res["small"] = {
            "agree": {n: float((gpu["labels"][n] == cpu["labels"][n]).mean())
                      for n in gpu["labels"]},
            "labels_present": {n: int(len(np.unique(v))) for n, v in gpu["labels"].items()},
            "tiles": spans["tiles"], "tile_forwards": tf, "expected": expect,
            "launches": got, "files": gpu["files"],
            "body_parts": gpu["report"]["body_parts"],
            "report_max_rel": _json_max_rel(gpu["report"], cpu["report"]),
            "part_s": time.perf_counter() - t_part}
        emit({"phase": "bca", "part": "small", **res["small"]})
        assert (spans["tiles"], tf) == (expect["tiles"], expect["tile_forwards"]), spans
        assert got == want, (got, want)
        assert min(res["small"]["agree"].values()) > 0.99, res["small"]["agree"]

    # --- (b) the BCA device passes at 512x512x300, card against the CPU
    t_part = time.perf_counter()
    shape, spacing = STUDY_SHAPE, (1.5, 1.5, 3.0)
    ct, parts, regions, vertebrae = _bca_phantom(shape, spacing)
    dev = torch.device("cuda")
    ct_dev = torch.from_numpy(ct).to(dev)
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()

    def passes(device) -> dict:
        on_card = device == "cuda"
        ct_in = ct_dev if on_card else ct
        sec, spans, out = {}, {}, {}
        for median in (False, True):
            t0 = time.perf_counter()
            out[median] = subclassify_tissues(ct_in, regions, median_filtering=median,
                                              device=device, spans=spans)
            sec["tissues_median" if median else "tissues"] = time.perf_counter() - t0
        host, tis_dev, reg_dev = out[False]
        t0 = time.perf_counter()
        b = Builder(ct_in, parts, regions, host, spacing, tissues_dev=tis_dev,
                    regions_dev=reg_dev, device=device, spans=spans)
        sec["builder"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        zc = b.region_z_counts()
        sec["region_z_counts"] = time.perf_counter() - t0
        b.examined_body_part = AggregatableBodyPart.from_body_regions(
            regions, spacing[2], z_counts=zc)
        t0 = time.perf_counter()
        prep = b.prepare(vertebrae)
        sec["prepare"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        js = b.create_json(**prep)
        sec["json"] = time.perf_counter() - t0
        return {"tissues": host, "tissues_median": out[True][0], "builder": b, "zc": zc,
                "prep": prep, "json": js, "sec": sec, "spans": spans}

    passes("cuda")   # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gpu = passes("cuda")
    peak = torch.cuda.max_memory_allocated() - resident
    alternatives = _one_hot_alternatives(
        torch, ct_dev, gpu["builder"]._tissues_dev, gpu["builder"]._regions_dev,
        torch.from_numpy(parts == 1).to(dev))
    cpu = passes("cpu")
    parts_ab = _parts_postprocess_ab(parts)
    g, c = gpu["builder"], cpu["builder"]
    hu_rel = max(float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300)))
                 for a, b in ((g._husums, c._husums), (g._husums_nl, c._husums_nl)))
    res["passes"] = {
        "voxels": int(np.prod(shape)), "gpu_s": gpu["sec"], "gpu_spans": gpu["spans"],
        "cpu_s": cpu["sec"], "cpu_spans": cpu["spans"],
        "peak_mem_gib_above_ct": peak / 2 ** 30, "one_hot_alternatives": alternatives,
        "hu_sum_max_rel": hu_rel, "json_max_rel": _json_max_rel(gpu["json"], cpu["json"]),
        "body_parts": gpu["json"]["body_parts"], "groups": list(gpu["json"]["aggregated"]),
        "tissue_voxels": np.bincount(gpu["tissues"].ravel(), minlength=8).tolist(),
        "parts_postprocess_s": parts_ab, "part_s": time.perf_counter() - t_part}
    emit({"phase": "bca", "part": "passes", **res["passes"]})
    for key in ("tissues", "tissues_median"):
        assert np.array_equal(gpu[key], cpu[key]), key
    for a, b in ((g._counts, c._counts), (g._counts_nl, c._counts_nl), (gpu["zc"], cpu["zc"])):
        assert np.array_equal(a, b)
    for ax in (1, 0):
        assert np.array_equal(gpu["prep"]["tissue_density"][ax], cpu["prep"]["tissue_density"][ax])
    assert hu_rel <= 1e-9 and res["passes"]["json_max_rel"] <= 1e-9, res["passes"]
    assert all(alternatives["agree"].values()), alternatives["agree"]
    assert gpu["json"]["body_parts"]["abdomen"] and len(gpu["json"]["aggregated"]) > 5
    del ct_dev, gpu, cpu, g, c

    # --- (c) the 512x512x300 study from its file: total fast, both BCA models
    #     at the total_fast widths with five folds
    t_part = time.perf_counter()
    study = _bca_study()
    tmp, store, img = study["root"], study["store"], study["img"]
    expect = _bca_tiles(img, (128, 128, 128), (3.0, 3.0, 3.0))
    runs = []
    for i in range(2 if timed else 1):
        spans = {}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset()
        t0 = time.perf_counter()
        compute_all_models(tmp / "ct.nii.gz", tmp / f"out{i}", ["total", "bca"],
                           store=store, totalsegmentator_params={"fast": True},
                           bca_params=params, spans=spans)
        dt = time.perf_counter() - t0
        runs.append({"s": dt, "spans": spans, "launches": launches(),
                     "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30})
    study["warm"] = True
    out = outputs(tmp / f"out{len(runs) - 1}", shape)
    res["study"] = {
        "sec": runs[1]["s"] if timed else None, "warmup_s": runs[0]["s"],
        "store_write_s": study["write_s"],
        "peak_mem_gib": runs[-1]["peak_mem_gib"], "spans": runs[-1]["spans"],
        "launches": runs[-1]["launches"], "expected": expect,
        "checkpoint_loads": store.loads, "files": out["files"],
        "labels_present": {n: int(len(np.unique(v))) for n, v in out["labels"].items()},
        "body_parts": out["report"]["body_parts"],
        "groups": list(out["report"]["aggregated"]),
        "part_s": time.perf_counter() - t_part}
    emit({"phase": "bca", "part": "study", **res["study"]})
    for r in runs:
        assert (r["spans"]["tiles"], r["spans"]["tile_forwards"]) == \
            (expect["tiles"], expect["tile_forwards"]), r["spans"]
        assert r["launches"] == _want_launches(expect["tile_forwards"]), r["launches"]
    assert store.loads == 3, store.loads   # total_fast, body_parts, body_regions
    return res


_BCA_STUDY: dict = {}


def _bca_study() -> dict:
    """bca (c)'s store (`total_fast` and both 5-fold BCA models at the
    total_fast widths, 128^3 patch) and its 512x512x300 CT file, written once
    per run of this script (the folder lives until the script exits) and
    shared with the cli phase's (c)."""
    if not _BCA_STUDY:
        from pathlib import Path

        from boa_tpu_torch.io import nifti
        from boa_tpu_torch.tasks.class_maps import get_class_map

        t0 = time.perf_counter()
        folder = tempfile.TemporaryDirectory()
        root = Path(folder.name)
        patch = (128, 128, 128)
        _store(root, TOTAL_FAST_FEATURES, patch,
               ["background"] + list(get_class_map("total").values()))
        _bca_store(root, TOTAL_FAST_FEATURES, patch)
        img = _bench_ct(STUDY_SHAPE, (1.5, 1.5, 3.0))
        nifti.save(img, root / "ct.nii.gz")
        _BCA_STUDY.update(folder=folder, root=root, img=img, store=_CountingStore(root),
                          warm=False, write_s=time.perf_counter() - t0)
    return _BCA_STUDY


CLI_SHEETS = ["info", "regions-statistics", "cnr-adjusted", "bca-aggregated-measurements",
              "bca-slice-measurements", "bca-slice-measurements_no_ext"]


def _sheets_max_rel(got: dict, want: dict) -> float:
    """Two read-back workbooks: the same sheets, rows and widths, strings,
    bools and empty cells equal, or raise; returns the largest relative
    difference of their numbers (an absolute 1e-12 counts as equal)."""
    if list(got) != list(want):
        raise AssertionError(f"sheets differ: {list(got)} != {list(want)}")
    worst = 0.0
    for name in want:
        if len(got[name]) != len(want[name]):
            raise AssertionError(f"{name}: {len(got[name])} rows != {len(want[name])}")
        for r, (g, w) in enumerate(zip(got[name], want[name])):
            if len(g) != len(w):
                raise AssertionError(f"{name} row {r}: width {len(g)} != {len(w)}")
            for a, b in zip(g, w):
                numeric = all(isinstance(v, (int, float)) and not isinstance(v, bool)
                              for v in (a, b))
                if not numeric:
                    if a != b or type(a) is not type(b):
                        raise AssertionError(f"{name} row {r}: {a!r} != {b!r}")
                elif abs(a - b) > 1e-12:
                    worst = max(worst, abs(a - b) / max(abs(a), abs(b)))
    return worst


def _debug_spans(text: str) -> dict:
    """The `_timed` spans ("<label> took <s> s") in a debug_information.txt."""
    return {m.group(1): float(m.group(2)) for m in re.finditer(
        r"\| ([^|\n]+) took ([0-9.]+) s$", text, re.M)}


def _cli_env(**extra) -> dict:
    """This process's environment without the CLI's env mirrors, plus `extra`."""

    env = {k: v for k, v in os.environ.items() if k not in (
        "DEVICE", "NVIDIA_ID", "THEME", "FAST_BCA", "FAST_TOTAL", "BCA_NO_PDF",
        "SKIP_CONTRAST_INFORMATION", "PREDICT_FAST", "BOA_TEST_ANATOMY", "BOA_PROFILE",
        "BOA_CONTRAST_MODEL", "BOA_GIT_MODEL", "BOA_PHASE_MODEL")}
    env.update(extra)
    return env


def _cli_study(torch, rc, pc, out_name: str, flags: list) -> dict:
    """`cli.run` in this process on bca (c)'s 512x512x300 file and stores,
    `-m total+bca --fast-total` (five BCA folds, contrast on) plus `flags`,
    into `<root>/<out_name>`, after bca (c)'s warm-up (run here when bca (c)
    has not run): seconds, analyze_ct's stats and its spans logged in the
    debug file, `compute_all_models`' spans, peak memory, the launches with
    the counts set to 0 just before the run, and the checkpoint loads."""
    from boa_tpu_torch import cli, commands
    from boa_tpu_torch.compute.inference import compute_all_models
    from boa_tpu_torch.weights.store import ModelStore

    study = _bca_study()
    root, img = study["root"], study["img"]
    if not study["warm"]:   # bca (c) did not run: warm up as it does
        compute_all_models(root / "ct.nii.gz", root / "warm", ["total", "bca"],
                           store=study["store"], totalsegmentator_params={"fast": True},
                           bca_params={"save_pdf": False})
        study["warm"] = True
    expect = _bca_tiles(img, (128, 128, 128), (3.0, 3.0, 3.0))
    captured, spans, loads = {}, {}, []
    analyze_ct, load = commands.analyze_ct, ModelStore.load

    def analyze_ct_spans(**kw):
        captured["result"] = analyze_ct(spans=spans, **kw)
        return captured["result"]

    def load_counted(self, *a, **kw):
        loads.append(a[0] if a else kw.get("task_id"))
        return load(self, *a, **kw)

    env_before = dict(os.environ)
    os.environ.update(BOA_WEIGHTS_PATH=str(root), BOA_TPU_CONFIG_DIR=str(root / "cfg"))
    commands.analyze_ct, ModelStore.load = analyze_ct_spans, load_counted
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        rc.reset_launches()
        pc.reset_launches()
        t0 = time.perf_counter()
        cli.run(["-i", str(root / "ct.nii.gz"), "-o", str(root / out_name), "-m", "total+bca",
                 "--fast-total", *flags])
        dt = time.perf_counter() - t0
        got = dict(rc.LAUNCHES, **pc.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
    finally:
        commands.analyze_ct, ModelStore.load = analyze_ct, load
        os.environ.clear()
        os.environ.update(env_before)
    stats = captured["result"][1]
    debug = (root / out_name / "debug_information.txt").read_text()
    return {
        "sec": dt, "stats": {k: v for k, v in stats.items()
                             if k.endswith("_time") or k in ("iv_contrast_phase",
                                                             "git_contrast", "bca_regions")},
        "logged_spans": _debug_spans(debug),   # analyze_ct's, at INFO under the CLI
        "peak_mem_gib": peak, "spans": spans, "launches": got, "expected": expect,
        "checkpoint_loads": loads, "checkpoint_loads_bca_study": study["store"].loads,
        "folder": root / out_name}


def phase_cli(torch, rc, pc) -> dict:
    """The front door, `python -m boa_tpu_torch`, from a CT file to its
    files and output.xlsx. (a) the command as a subprocess with `--device
    cuda` on bca (a)'s small stores (one BCA fold: --fast-bca) and 96x96x32
    file, `-m total+bca --bca-no-pdf`, contrast on: exit 0, the six sheets,
    the debug file names the card, labels agree > 0.99 with the same run
    in-process on the CPU, the prediction counter rose by the number of
    predict_image calls; (b) `analyze_ct` through the anatomy phantom's hook
    at 512x512x150 (statistics, the engine and the BCA passes on the device)
    on the card and on the CPU: every numeric cell of every sheet within
    1e-6 relative, strings and empty cells equal; (c) `cli.run` in-process on
    bca (c)'s 512x512x300 file and stores, `-m total+bca --fast-total
    --bca-no-pdf`, five BCA folds, contrast on: one timed run after bca (c)'s
    warm-up with seconds, analyze_ct's stats, spans, peak memory and
    launches tiles x folds x (4, 1, 1), no K5, no model loaded again."""
    import json
    from pathlib import Path

    from boa_tpu_torch import cli, commands
    from boa_tpu_torch.bca import pipeline as bca_pipeline
    from boa_tpu_torch.compute import inference as inference_mod
    from boa_tpu_torch.io import nifti
    from boa_tpu_torch.io.xlsx import read_xlsx
    from boa_tpu_torch.testing import anatomy

    repo = Path(__file__).resolve().parent
    card = torch.cuda.get_device_name(0)
    res = {}

    def files_of(folder: Path) -> dict:
        """The label files load, the workbook has its six sheets and the
        debug file names the card."""
        files = sorted(p.name for p in folder.iterdir())
        for name in ("output.xlsx", "debug_information.txt", "total.nii.gz",
                     "total-measurements.json", "bca-measurements.json", "tissues.nii.gz"):
            assert name in files, (name, files)
        sheets = read_xlsx(folder / "output.xlsx")
        assert list(sheets) == CLI_SHEETS, list(sheets)
        return {"files": files, "sheets": sheets,
                "labels": {n: nifti.load(folder / n).data for n in files
                           if n.endswith(".nii.gz")},
                "debug": (folder / "debug_information.txt").read_text()}

    # --- (a) the command as a subprocess on the card, against the CPU
    t_part = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        patch = (32, 32, 32)
        _parts_store(tmp / "w", SMALL_RUN_FEATURES, patch, (1.5, 1.5, 1.5))
        _bca_store(tmp / "w", SMALL_RUN_FEATURES, patch)
        nifti.save(_bench_ct(SMALL_RUN_SHAPE, (1.5, 1.5, 3.0)), tmp / "ct.nii.gz")
        args = ["-i", str(tmp / "ct.nii.gz"), "-m", "total+bca", "--fast-bca", "--bca-no-pdf"]
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "boa_tpu_torch", *args, "-o", str(tmp / "gpu"),
             "--device", "cuda"], cwd=repo, capture_output=True, text=True, timeout=600,
            env=_cli_env(BOA_WEIGHTS_PATH=str(tmp / "w"), BOA_TPU_CONFIG_DIR=str(tmp / "cfg")))
        sub_s = time.perf_counter() - t0
        assert proc.returncode == 0, proc.stderr[-4000:]
        counter = json.loads((tmp / "cfg" / "config.json").read_text())["prediction_counter"]
        # the same run in this process on the CPU, counting predict_image's calls
        calls = []

        def counted(fn):
            def call(*a, **kw):
                calls.append(a[1])
                return fn(*a, **kw)
            return call

        saved = {m: m.predict_image for m in (inference_mod, bca_pipeline)}
        env_before = dict(os.environ)
        os.environ.update(BOA_WEIGHTS_PATH=str(tmp / "w"),
                          BOA_TPU_CONFIG_DIR=str(tmp / "cfg_cpu"))
        try:
            for m, fn in saved.items():
                m.predict_image = counted(fn)
            t0 = time.perf_counter()
            cli.run([*args, "-o", str(tmp / "cpu"), "--device", "cpu"])
            cpu_s = time.perf_counter() - t0
        finally:
            for m, fn in saved.items():
                m.predict_image = fn
            os.environ.clear()
            os.environ.update(env_before)
        cpu_counter = json.loads((tmp / "cfg_cpu" / "config.json").read_text())[
            "prediction_counter"]
        gpu, cpu = files_of(tmp / "gpu"), files_of(tmp / "cpu")
        res["command"] = {
            "subprocess_s": sub_s, "cpu_in_process_s": cpu_s, "files": gpu["files"],
            "agree": {n: float((gpu["labels"][n] == cpu["labels"][n]).mean())
                      for n in gpu["labels"]},
            "labels_present": {n: int(len(np.unique(v))) for n, v in gpu["labels"].items()},
            "prediction_counter": counter, "predict_image_calls": calls,
            "debug_header": gpu["debug"].split("\n\n")[0].splitlines(),
            "info": gpu["sheets"]["info"], "part_s": time.perf_counter() - t_part}
    emit({"phase": "cli", "part": "command", **res["command"]})
    assert gpu["files"] == cpu["files"], (gpu["files"], cpu["files"])
    assert gpu["debug"].startswith("Platform: ") and card in gpu["debug"]
    assert min(res["command"]["agree"].values()) > 0.99, res["command"]["agree"]
    assert counter == cpu_counter == len(calls) == 3, (counter, cpu_counter, calls)
    assert any(r[0] == "PredictedContrastPhase" for r in gpu["sheets"]["info"])

    # --- (b) the sheets through the anatomy phantom's hook, card against CPU
    t_part = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        spacing = (1.5, 1.5, 3.0)
        nifti.save(nifti.NiftiImage(data=anatomy.synth_ct(SHEETS_SHAPE, spacing),
                                    affine=np.diag([*spacing, 1.0])), tmp / "ct.nii.gz")
        kw = dict(models=["total", "bca"], fast_total=True, bca_pdf=False,
                  total_preview=False, cnr_adjustment=True)
        sec, stats, sheets = {}, {}, {}
        for device in ("cuda", "cpu"):
            t0 = time.perf_counter()
            path, stats[device] = commands.analyze_ct(
                tmp / "ct.nii.gz", tmp / device, tmp / device,
                fake_predict=anatomy.fake_predict_factory(), device=device, **kw)
            sec[device] = time.perf_counter() - t0
            sheets[device] = read_xlsx(path)
        res["sheets"] = {
            "sec": sec, "stats": {d: {k: v for k, v in s.items() if k.endswith("_time")}
                                  for d, s in stats.items()},
            "rows": {n: len(v) for n, v in sheets["cuda"].items()},
            "max_rel": _sheets_max_rel(sheets["cuda"], sheets["cpu"]),
            "info": sheets["cuda"]["info"], "part_s": time.perf_counter() - t_part}
    emit({"phase": "cli", "part": "sheets", **res["sheets"]})
    assert list(sheets["cuda"]) == CLI_SHEETS
    assert res["sheets"]["max_rel"] <= 1e-6, res["sheets"]["max_rel"]
    assert len(sheets["cuda"]["bca-slice-measurements"]) == SHEETS_SHAPE[2] + 1
    assert any(r[0] == "PredictedContrastPhase" for r in sheets["cuda"]["info"])

    # --- (c) the full-width study through cli.run, after bca (c)'s warm-up
    t_part = time.perf_counter()
    run = _cli_study(torch, rc, pc, "cli", ["--bca-no-pdf"])
    out = files_of(run.pop("folder"))
    expect, spans, got, loads = run["expected"], run["spans"], run["launches"], \
        run["checkpoint_loads"]
    res["study"] = {
        **run, "files": out["files"], "rows": {n: len(v) for n, v in out["sheets"].items()},
        "info": out["sheets"]["info"], "part_s": time.perf_counter() - t_part}
    emit({"phase": "cli", "part": "study", **res["study"]})
    assert card in out["debug"] and "Contrast phase prediction" in run["logged_spans"], \
        run["logged_spans"]
    assert (spans["tiles"], spans["tile_forwards"]) == \
        (expect["tiles"], expect["tile_forwards"]), spans
    assert got == _want_launches(expect["tile_forwards"]), got
    # each model loaded once: by bca (c) (or the warm-up), none here
    assert not loads and run["checkpoint_loads_bca_study"] == 3, \
        (loads, run["checkpoint_loads_bca_study"])
    return res


def phase_dicom(torch, rc, pc) -> dict:
    """DICOM ingestion, from a CT series directory to the study's files.
    (a) a 96x96x64 bench CT written as a JPEG-LS series by the port's
    `write_ct_series`, through `analyze_ct` with the small checks' models
    (`-m total` fast: `total_fast` at widths 32/64/128, 32^3 patch; contrast
    on) on the card and in this process on the CPU:
    image.nii.gz equal to the source voxels, total.nii.gz labels agree
    > 0.99, the info sheets' DICOM rows equal, the "Study ingest took" line
    in the debug file, launches tiles x (4, 1, 1) with the split plan's
    finishing passes; (b) one 512x512 slice of the bench CT as RLE, JPEG
    Lossless SV1, JPEG-LS, JPEG 2000 and 12-bit JPEG Extended: the host
    library's decode (median of 5, ms) bit-identical to the source for the
    lossless syntaxes and to its plain version (one call; JPEG 2000's on a
    128x128 crop), the library's build seconds; (c) the bench's 512x512x300
    CT as an uncompressed series through `cli.run` (`-m total --fast-total`,
    contrast on) on bca (c)'s store: seconds, the ingest span, analyze_ct's
    stats, peak memory, launches tiles x (4, 1, 1) with no K5, image.nii.gz
    equal to the source (affine within 1e-6), total.nii.gz agreeing > 0.99
    with cli (c)'s (or with the same command on the NIfTI file when the cli
    phase did not run), and the estimated ingest of a 300-slice JPEG-LS
    series."""
    import logging
    from pathlib import Path

    from boa_tpu_torch import cli, commands, native
    from boa_tpu_torch.io import dicom, dicom_io, nifti
    from boa_tpu_torch.io.xlsx import read_xlsx
    from boa_tpu_torch.native.timing import time_decoders
    from boa_tpu_torch.tasks.class_maps import get_class_map
    from boa_tpu_torch.weights.store import ModelStore

    res = {}
    t_phase = time.perf_counter()
    native.build_all()   # the host decoders: g++ at first use
    res["build"] = {k: native.build_info[k] for k in ("seconds", "cached", "dir")}

    def launches() -> dict:
        return dict(rc.LAUNCHES, **pc.LAUNCHES)

    def reset() -> None:
        rc.reset_launches()
        pc.reset_launches()

    def dicom_names(folder: Path) -> set:
        """The names of the info rows a series gives (extract_metadata's)."""
        first = sorted(folder.iterdir())[0]
        return {r["name"] for r in dicom_io.extract_metadata(
            dicom.dcmread(first, stop_before_pixels=True))}

    # --- (a) a JPEG-LS series through analyze_ct, card against CPU
    t_part = time.perf_counter()
    pkg_logger = logging.getLogger("boa_tpu_torch")
    level = pkg_logger.level
    pkg_logger.setLevel(logging.INFO)   # as the CLI sets it: the spans reach the debug file
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        patch = (32, 32, 32)
        store = _store(tmp / "w", (32, 64, 128), patch,
                       ["background"] + list(get_class_map("total").values()))
        img = _bench_ct((96, 96, 64), (1.5, 1.5, 3.0))
        t0 = time.perf_counter()
        dicom_io.write_ct_series(img, tmp / "series", transfer_syntax=dicom.JPEG_LS_LOSSLESS)
        write_s = time.perf_counter() - t0
        names = dicom_names(tmp / "series")
        out, sec, spans = {}, {}, {}
        try:
            for device in ("cuda", "cpu"):
                reset()
                t0 = time.perf_counter()
                commands.analyze_ct(tmp / "series", tmp / device, tmp / device, ["total"],
                                    total_preview=False, fast_total=True, device=device,
                                    store=store, spans=spans.setdefault(device, {}))
                sec[device] = time.perf_counter() - t0
                out[device] = {
                    "launches": launches(),
                    "image": nifti.load(tmp / device / "image.nii.gz"),
                    "labels": nifti.load(tmp / device / "total.nii.gz").data,
                    "info": read_xlsx(tmp / device / "output.xlsx")["info"],
                    "debug": (tmp / device / "debug_information.txt").read_text()}
        finally:
            pkg_logger.setLevel(level)
        gpu, cpu = out["cuda"], out["cpu"]
        tiles = spans["cuda"]["tiles"]
        want = _want_launches(tiles, _rows_finish(torch, pc, tiles, patch, 32))
        rows = {d: [r for r in o["info"] if r and r[0] in names] for d, o in out.items()}
        res["series"] = {
            "transfer_syntax": dicom.JPEG_LS_LOSSLESS, "slices": img.shape[2],
            "write_s": write_s, "sec": sec,
            "ingest_s": {d: _debug_spans(o["debug"])["Study ingest"] for d, o in out.items()},
            "agree": float((gpu["labels"] == cpu["labels"]).mean()),
            "labels_present": int(len(np.unique(gpu["labels"]))),
            "image_equal": bool(np.array_equal(gpu["image"].data, img.data)
                                and np.array_equal(cpu["image"].data, img.data)),
            "affine_max_err": float(np.abs(gpu["image"].affine - img.affine).max()),
            "dicom_rows": rows["cuda"], "launches": gpu["launches"], "expected": want,
            "contrast_rows": [r for r in gpu["info"] if r[0].startswith("PredictedContrast")],
            "part_s": time.perf_counter() - t_part}
    emit({"phase": "dicom", "part": "series", **res["series"]})
    assert res["series"]["image_equal"] and res["series"]["affine_max_err"] <= 1e-6
    assert res["series"]["agree"] > 0.99, res["series"]["agree"]
    assert rows["cuda"] == rows["cpu"] and len(rows["cuda"]) == len(names), rows
    assert all("Study ingest took" in o["debug"] for o in out.values())
    assert res["series"]["contrast_rows"], gpu["info"]
    assert gpu["launches"] == want, (gpu["launches"], want)

    # --- (b) the host decoders against their plain versions, one 512x512 slice
    study = _bca_study()   # written once: bca (c)'s store and CT, shared with (c)
    root, img = study["root"], study["img"]
    t_part = time.perf_counter()
    sl = np.ascontiguousarray(img.data[:, :, STUDY_SHAPE[2] // 2].T)   # (rows, cols) int16
    decoders = time_decoders(sl)["codecs"]
    res["decoders"] = {"slice": f"z = {STUDY_SHAPE[2] // 2} of the bench CT, 512x512 int16",
                       "build": res["build"], "codecs": decoders,
                       "part_s": time.perf_counter() - t_part}
    emit({"phase": "dicom", "part": "decoders", **res["decoders"]})

    # --- (c) the full-width study from an uncompressed series through cli.run
    t_part = time.perf_counter()
    t0 = time.perf_counter()
    dicom_io.write_ct_series(img, root / "series")
    series_write_s = time.perf_counter() - t0
    expect = _bca_tiles(img, (128, 128, 128), (3.0, 3.0, 3.0))["total"]
    captured, spans, loads = {}, {}, []
    analyze_ct, load = commands.analyze_ct, ModelStore.load

    def analyze_ct_spans(**kw):
        captured["result"] = analyze_ct(spans=spans, **kw)
        return captured["result"]

    def load_counted(self, *a, **kw):
        loads.append(a[0] if a else kw.get("task_id"))
        return load(self, *a, **kw)

    args = ["-m", "total", "--fast-total"]
    env_before = dict(os.environ)
    os.environ.update(BOA_WEIGHTS_PATH=str(root), BOA_TPU_CONFIG_DIR=str(root / "cfg"))
    try:
        ref_dir = root / "cli"
        if not (ref_dir / "total.nii.gz").exists():   # no cli phase: its file, as reference
            ref_dir = root / "dicom_ref"
            t0 = time.perf_counter()
            cli.run(["-i", str(root / "ct.nii.gz"), "-o", str(ref_dir), *args])
            res["nifti_reference_s"] = time.perf_counter() - t0
        commands.analyze_ct, ModelStore.load = analyze_ct_spans, load_counted
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset()
        t0 = time.perf_counter()
        cli.run(["-i", str(root / "series"), "-o", str(root / "dicom"), *args])
        dt = time.perf_counter() - t0
        got = launches()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
    finally:
        commands.analyze_ct, ModelStore.load = analyze_ct, load
        os.environ.clear()
        os.environ.update(env_before)
    t0 = time.perf_counter()
    dicom_io.read_series(root / "series")   # the ingest's read alone, without the save
    read_series_s = time.perf_counter() - t0
    stats = captured["result"][1]
    logged = _debug_spans((root / "dicom" / "debug_information.txt").read_text())
    image = nifti.load(root / "dicom" / "image.nii.gz")
    labels = nifti.load(root / "dicom" / "total.nii.gz").data
    ref_labels = nifti.load(ref_dir / "total.nii.gz").data
    info = read_xlsx(root / "dicom" / "output.xlsx")["info"]
    jls_ms = decoders["jpeg_ls"]["library_ms"]
    res["study"] = {
        "sec": dt, "ingest_s": logged["Study ingest"], "read_series_s": read_series_s,
        "series_write_s": series_write_s,
        "stats": {k: v for k, v in stats.items()
                  if k.endswith("_time") or k in ("iv_contrast_phase", "git_contrast")},
        "logged_spans": logged, "spans": spans, "peak_mem_gib": peak,
        "launches": got, "expected_tiles": expect, "checkpoint_loads": loads,
        "image_equal": bool(np.array_equal(image.data, img.data)),
        "affine_max_err": float(np.abs(image.affine - img.affine).max()),
        "agree_with": str(ref_dir.relative_to(root)) + "/total.nii.gz",
        "agree": float((labels == ref_labels).mean()),
        "labels_present": int(len(np.unique(labels))),
        "dicom_rows": [r for r in info if r and r[0] in dicom_names(root / "series")],
        "jpeg_ls_300_slice_ingest_estimate_s": {
            "library": 300 * jls_ms / 1e3,
            "plain": 300 * decoders["jpeg_ls"]["plain_ms"] / 1e3,
            "note": "an estimate: 300 x (b)'s one-slice decode, not a measured ingest"},
        "part_s": time.perf_counter() - t_part}
    res["phase_s"] = time.perf_counter() - t_phase
    emit({"phase": "dicom", "part": "study", **res["study"], "phase_s": res["phase_s"],
          **({"nifti_reference_s": res["nifti_reference_s"]}
             if "nifti_reference_s" in res else {})})
    assert res["study"]["image_equal"] and res["study"]["affine_max_err"] <= 1e-6
    assert res["study"]["agree"] > 0.99, res["study"]["agree"]
    assert spans["tiles"] == expect, (spans["tiles"], expect)
    assert got == _want_launches(expect), got
    assert any(r[0] == "PredictedContrastPhase" for r in info)
    return res


def _png_rgb(path) -> np.ndarray:
    """A PNG of the port's writer (8-bit RGB or RGBA, filter 0 on every
    row) as a (height, width, 3) uint8 array."""
    import struct
    import zlib

    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n", path
    pos, idat, header = 8, b"", None
    while pos < len(data):
        n = struct.unpack(">I", data[pos:pos + 4])[0]
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    w, h, depth, ctype = header[:4]
    channels = {2: 3, 6: 4}[ctype]
    assert depth == 8, header
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + w * channels)
    assert not rows[:, 0].any()
    return rows[:, 1:].reshape(h, w, channels)[..., :3]


def _panel_colour(rgb: np.ndarray) -> list[int]:
    """Pixels of saturation above 0.15 in each of the montage's five panels
    (tests/test_bca.py's bar wants more than 50 in each)."""
    return [int(((p.max(-1) - p.min(-1)) > 0.15).sum())
            for p in np.array_split(rgb.astype(np.float32) / 255, 5, axis=1)]


def _pdf_pages(data: bytes) -> int:
    return data.count(b"/Type /Page") - data.count(b"/Type /Pages")


def phase_render(torch, rc, pc) -> dict:
    """The renderers: (a) the preview's front pass on the card at 512x512x300
    (the anatomy phantom's `total` labels, every ROI group filled): CUDA-event
    ms of `_group_fronts_device` (median of 5 after a warm-up) against the
    plain host version (`_label_depths` + `_group_fronts_from_depths`, timed
    once): fronts, label indices and label lists equal to the bit, and the
    montages drawn from both byte-identical, 1760 x 660, with the montage's
    seconds; (b) `analyze_ct` through the anatomy hook at 512x512x300 with
    `total_preview=True, bca_pdf=True` on the card: report.pdf has 3 + one
    page per aggregation window, preview_total.png more than 50 coloured
    pixels in every panel, and the spans of the front pass, the deferred
    montage and the PDF; (c) `cli.run` on bca (c)'s file and stores,
    `-m total+bca --fast-total --preview` with the PDF on: seconds, stats,
    spans, peak memory, launches tiles x folds x (4, 1, 1) with no K5 and no
    model loaded again, both files written."""
    from pathlib import Path

    from boa_tpu_torch import commands
    from boa_tpu_torch.compute import preview
    from boa_tpu_torch.io import nifti
    from boa_tpu_torch.tasks.class_maps import get_class_map
    from boa_tpu_torch.testing import anatomy

    res = {}
    spacing = (1.5, 1.5, 3.0)

    # --- (a) the front pass on the card against its plain host version
    t_part = time.perf_counter()
    seg = anatomy.fake_total_seg(STUDY_SHAPE, spacing)
    ct = anatomy.synth_ct(STUDY_SHAPE, spacing)
    cmap = get_class_map("total")
    inv = {v: k for k, v in cmap.items()}
    n_labels = max(cmap) + 1
    seg_dev = torch.from_numpy(seg).cuda()
    preview._group_fronts_device(seg_dev, inv, n_labels)   # warm-up
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        dev = preview._group_fronts_device(seg_dev, inv, n_labels)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    t0 = time.perf_counter()
    host = preview._group_fronts_from_depths(preview._label_depths(seg, n_labels), inv)
    host_s = time.perf_counter() - t0
    equal = {}
    for group in preview.ROI_GROUPS:
        (fd, wd, ld), (fh, wh, lh) = dev[group], host[group]
        equal[group] = bool(ld == lh and fd.dtype == fh.dtype and wd.dtype == wh.dtype
                            and np.array_equal(fd, fh) and np.array_equal(wd, wh))
    aspect = spacing[2] / spacing[1]
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        preview._render_montage(ct, dev, aspect, tmp / "dev.png")
        montage_s = time.perf_counter() - t0
        preview._render_montage(ct, host, aspect, tmp / "host.png")
        same_png = (tmp / "dev.png").read_bytes() == (tmp / "host.png").read_bytes()
        rgb = _png_rgb(tmp / "dev.png")
    res["fronts"] = {
        "shape": list(STUDY_SHAPE), "device_ms": statistics.median(times), "device_ms_all": times,
        "host_s": host_s, "montage_s": montage_s, "equal": equal, "png_identical": same_png,
        "png_shape": list(rgb.shape), "panel_colour_px": _panel_colour(rgb),
        "hit_px": {g: int(np.isfinite(dev[g][0]).sum()) for g in preview.ROI_GROUPS},
        "part_s": time.perf_counter() - t_part}
    emit({"phase": "render", "part": "fronts", **res["fronts"]})
    assert all(equal.values()) and same_png, (equal, same_png)
    assert rgb.shape == (660, 1760, 3) and min(res["fronts"]["panel_colour_px"]) > 50
    del seg_dev

    # --- (b) the product path through the anatomy hook, renders on
    t_part = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        nifti.save(nifti.NiftiImage(data=ct, affine=np.diag([*spacing, 1.0])),
                   tmp / "ct.nii.gz")
        spans: dict = {}
        t0 = time.perf_counter()
        _, stats = commands.analyze_ct(
            tmp / "ct.nii.gz", tmp / "out", tmp / "out", models=["total", "bca"],
            fast_total=True, total_preview=True, bca_pdf=True, cnr_adjustment=True,
            fake_predict=anatomy.fake_predict_factory(), device="cuda", spans=spans)
        sec = time.perf_counter() - t0
        out = tmp / "out"
        pages = _pdf_pages((out / "report.pdf").read_bytes())
        n_aggs = len(json.loads((out / "bca-measurements.json").read_text())["aggregated"])
        rgb = _png_rgb(out / "preview_total.png")
        res["product"] = {
            "sec": sec, "stats": {k: v for k, v in stats.items() if k.endswith("_time")},
            "render_spans": {k: spans[k] for k in ("preview_fronts", "preview_render",
                                                   "report_pdf")},
            "spans": spans, "pdf_pages": pages, "aggregations": n_aggs,
            "pdf_bytes": (out / "report.pdf").stat().st_size,
            "png_shape": list(rgb.shape), "panel_colour_px": _panel_colour(rgb),
            "part_s": time.perf_counter() - t_part}
    emit({"phase": "render", "part": "product", **res["product"]})
    assert pages == 3 + n_aggs, (pages, n_aggs)
    assert rgb.shape == (660, 1760, 3) and min(res["product"]["panel_colour_px"]) > 50

    # --- (c) the timed product command, renders on
    t_part = time.perf_counter()
    run = _cli_study(torch, rc, pc, "render", ["--preview"])
    folder = run.pop("folder")
    sizes = {n: (folder / n).stat().st_size for n in ("report.pdf", "preview_total.png")}
    expect, spans, got = run["expected"], run["spans"], run["launches"]
    res["study"] = {**run, "render_sizes": sizes,
                    "render_spans": {k: spans.get(k) for k in (
                        "preview_fronts", "preview_render", "report_pdf")},
                    "files": sorted(p.name for p in folder.iterdir()),
                    "part_s": time.perf_counter() - t_part}
    emit({"phase": "render", "part": "study", **res["study"]})
    assert min(sizes.values()) > 0, sizes
    assert (spans["tiles"], spans["tile_forwards"]) == \
        (expect["tiles"], expect["tile_forwards"]), spans
    assert got == _want_launches(expect["tile_forwards"]), got
    assert not run["checkpoint_loads"] and run["checkpoint_loads_bca_study"] == 3, \
        (run["checkpoint_loads"], run["checkpoint_loads_bca_study"])
    return res


# --- phase 12: the TotalSegmentator API and its writers ----------------------

_DICOM_VOLATILE = {"SOPInstanceUID", "SeriesInstanceUID", "MediaStorageSOPInstanceUID",
                   "DimensionOrganizationUID", "SeriesDate", "SeriesTime", "ContentDate",
                   "ContentTime", "StructureSetDate", "StructureSetTime"}


def _same_dicom(got, want, path="") -> None:
    """Two datasets element for element, apart from UIDs, dates and times."""
    from boa_tpu_torch.io.dicom import TAG_TO_KEYWORD

    if sorted(got.keys()) != sorted(want.keys()):
        raise AssertionError(f"{path}: elements differ")
    for tag in sorted(want.keys()):
        kw = TAG_TO_KEYWORD.get(tag, str(tag))
        if kw in _DICOM_VOLATILE:
            continue
        g, w = got.get(tag), want.get(tag)
        if isinstance(w, list) and w and hasattr(w[0], "keys"):
            if len(g) != len(w):
                raise AssertionError(f"{path}/{kw}: {len(g)} items != {len(w)}")
            for i, (a, b) in enumerate(zip(g, w)):
                _same_dicom(a, b, f"{path}/{kw}[{i}]")
        elif g != w:
            raise AssertionError(f"{path}/{kw} differs")


def _rtstruct_checks(rt, labels: np.ndarray, label_map: dict, headers) -> dict:
    """One ROI per present label; every contour closed planar, >= 3 points,
    each point on the centre of a pixel of its label's border (a pixel of
    the label with a 4-neighbour outside it or outside the slice) in the
    slice its contour image names."""
    present = sorted(int(v) for v in np.unique(labels) if v and int(v) in label_map)
    names = [r.ROIName for r in rt.StructureSetROISequence]
    assert names == [label_map[v] for v in present], (names, present)
    iop = np.asarray(headers[0].get("ImageOrientationPatient"), float)
    row_sp, col_sp = (float(v) for v in headers[0].get("PixelSpacing"))
    col_dir, row_dir = iop[:3], iop[3:]
    z_of = {h.get("SOPInstanceUID"): z for z, h in enumerate(headers)}
    n_contours = n_points = 0
    worst = 0.0
    for lb, rc in zip(present, rt.ROIContourSequence):
        mask = labels == lb
        for c in rc.ContourSequence:
            pts = np.asarray(c.ContourData, float).reshape(-1, 3)
            assert c.ContourGeometricType == "CLOSED_PLANAR" and len(pts) >= 3
            assert int(c.NumberOfContourPoints) == len(pts)
            z = z_of[c.ContourImageSequence[0].ReferencedSOPInstanceUID]
            ipp = np.asarray(headers[z].get("ImagePositionPatient"), float)
            x = (pts - ipp) @ col_dir / col_sp
            y = (pts - ipp) @ row_dir / row_sp
            xi, yi = np.rint(x).astype(int), np.rint(y).astype(int)
            worst = max(worst, float(np.abs(x - xi).max()), float(np.abs(y - yi).max()))
            sl = np.pad(mask[:, :, z], 1)
            xi, yi = xi + 1, yi + 1
            assert sl[xi, yi].all(), (lb, z)
            inner = sl[xi - 1, yi] & sl[xi + 1, yi] & sl[xi, yi - 1] & sl[xi, yi + 1]
            assert not inner.any(), (lb, z)
            n_contours += 1
            n_points += len(pts)
    assert worst < 1e-3, worst
    return {"rois": len(names), "contours": n_contours, "points": n_points,
            "max_off_centre_px": worst}


def _total_fast_store():
    """The full-width `total_fast` store (task 297, widths 32..320, 128^3
    patch): bca (c)'s when that phase wrote it, else one of its own,
    written once per run of this script."""
    if _BCA_STUDY:
        return _BCA_STUDY["store"]
    if "total_fast" not in _SHARED_STORES:
        from boa_tpu_torch.tasks.class_maps import get_class_map

        folder = tempfile.TemporaryDirectory()
        _store(folder.name, TOTAL_FAST_FEATURES, (128, 128, 128),
               ["background"] + list(get_class_map("total").values()))
        _SHARED_STORES["total_fast"] = (folder, _CountingStore(folder.name))
    return _SHARED_STORES["total_fast"][1]


def phase_api(torch, rc, pc) -> dict:
    """The TotalSegmentator API (`boa_tpu_torch.python_api.totalsegmentator`)
    and its writers, on the full-width `total_fast` store with the anatomy
    phantom's hook set to `run_real` (the real forward runs on K1-K3, the
    labels measured and written are the phantom's): (a) the 512x512x150
    phantom from its .nii.gz with statistics, radiomics and the preview,
    per-class masks: seconds, spans, peak memory, launches tiles x (4, 1, 1);
    the 117 masks byte-identical to the same call on the CPU with the plain
    hook, statistics.json within 1e-3 HU (volumes equal),
    statistics_radiomics.json within 1e-9 relative (counts equal), the
    preview PNGs byte-identical; (b) a 512x512x64 series of the phantom
    written by `write_ct_series` through `ml=True,
    output_type=["nifti", "dicom_seg", "dicom_rtstruct"]`: the DICOM-SEG read
    back equal to the NIfTI labels voxel for voxel, one RTSTRUCT ROI per
    present label with every contour closed, of >= 3 points, on the pixel
    centres of its label's border, both objects equal to the CPU run's
    apart from UIDs, dates and times, the writers' and the tracer's
    seconds; (c) `cli.run -m total --fast-total --radiomics` through the
    anatomy hook on a 96x96x32 phantom at 3.5 x 3.5 x 9 mm:
    statistics_radiomics.json written for total and ct_pfav, no launch
    (the hook replaces the forward)."""
    from pathlib import Path

    from boa_tpu_torch import cli
    from boa_tpu_torch.io import dicom, dicom_io, dicom_seg, nifti
    from boa_tpu_torch.python_api import totalsegmentator
    from boa_tpu_torch.testing import anatomy

    res = {}
    t_phase = time.perf_counter()
    store = _total_fast_store()
    spacing = (1.5, 1.5, 3.0)
    tmp_dir = tempfile.TemporaryDirectory()
    root = Path(tmp_dir.name)

    def real_hook():
        fake = anatomy.fake_predict_factory()
        fake.run_real = True   # the real forward runs first; its labels are dropped
        return fake

    def counts():
        return dict(rc.LAUNCHES, **pc.LAUNCHES)

    def reset():
        rc.reset_launches()
        pc.reset_launches()

    # --- (a) the NIfTI study with statistics, radiomics and the preview
    t_part = time.perf_counter()
    ct = anatomy.synth_ct(API_SHAPE, spacing)
    nifti.save(nifti.NiftiImage(data=ct, affine=np.diag([*spacing, 1.0])), root / "ct.nii.gz")
    kw = dict(task="total", fast=True, statistics=True, radiomics=True, preview=True,
              store=store)
    spans: dict = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset()
    t0 = time.perf_counter()
    _, stats = totalsegmentator(root / "ct.nii.gz", root / "gpu", fake_predict=real_hook(),
                                spans=spans, **kw)
    sec = time.perf_counter() - t0
    got = counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    t0 = time.perf_counter()
    _, stats_cpu = totalsegmentator(root / "ct.nii.gz", root / "cpu", device="cpu",
                                    fake_predict=anatomy.fake_predict_factory(), **kw)
    cpu_s = time.perf_counter() - t0
    files = sorted(p.name for p in (root / "gpu").iterdir())
    masks = [n for n in files if n.endswith(".nii.gz")]
    same_masks = [n for n in masks
                  if (root / "gpu" / n).read_bytes() == (root / "cpu" / n).read_bytes()]
    rad = json.loads((root / "gpu" / "statistics_radiomics.json").read_text())
    rad_cpu = json.loads((root / "cpu" / "statistics_radiomics.json").read_text())
    counts_equal = all(rad[k].get("voxels") == rad_cpu[k].get("voxels") for k in rad_cpu)
    rad_rel = _json_max_rel(rad, rad_cpu)
    stats_file = json.loads((root / "gpu" / "statistics.json").read_text())
    stats_cpu_file = json.loads((root / "cpu" / "statistics.json").read_text())
    volumes_equal = all(stats_file[k]["volume"] == stats_cpu_file[k]["volume"]
                        for k in stats_cpu_file) and list(stats_file) == list(stats_cpu_file)
    hu_err = max(abs(stats_file[k]["intensity"] - stats_cpu_file[k]["intensity"])
                 for k in stats_cpu_file)
    same_png = (root / "gpu" / "preview_total.png").read_bytes() == \
        (root / "cpu" / "preview_total.png").read_bytes()
    res["nifti"] = {
        "shape": list(API_SHAPE), "sec": sec, "cpu_s": cpu_s, "peak_mem_gib": peak,
        "spans": spans,
        "stages": {k: spans.get(k) for k in ("predict", "statistics", "radiomics_histogram",
                                             "radiomics_shape", "save_nifti",
                                             "preview_fronts", "preview_render")},
        "tiles": spans["tiles"], "launches": got, "masks": len(masks),
        "masks_identical": len(same_masks), "stats_volumes_equal": volumes_equal,
        "stats_max_hu_err": hu_err, "radiomics_counts_equal": counts_equal,
        "radiomics_max_rel": rad_rel, "preview_identical": same_png,
        "classes_present": sum(1 for v in rad.values() if v.get("present")),
        "stats_returned_equal_file": stats == stats_file,
        "part_s": time.perf_counter() - t_part}
    emit({"phase": "api", "part": "nifti", **res["nifti"]})
    assert got == _want_launches(spans["tiles"]), got
    assert len(masks) == 117 and len(same_masks) == len(masks), (len(masks), len(same_masks))
    assert volumes_equal and hu_err <= 1e-3, hu_err
    assert counts_equal and rad_rel <= 1e-9, rad_rel
    assert same_png and res["nifti"]["classes_present"] > 20
    assert stats_cpu == stats_cpu_file
    shutil.rmtree(root / "cpu")
    shutil.rmtree(root / "gpu")

    # --- (b) DICOM in, DICOM out
    t_part = time.perf_counter()
    t0 = time.perf_counter()
    del ct
    dicom_io.write_ct_series(nifti.NiftiImage(data=anatomy.synth_ct((512, 512, 64), spacing),
                                              affine=np.diag([*spacing, 1.0])),
                             root / "series")
    series_write_s = time.perf_counter() - t0
    types = ["nifti", "dicom_seg", "dicom_rtstruct"]
    spans = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset()
    t0 = time.perf_counter()
    totalsegmentator(root / "series", root / "dcm_gpu", task="total", fast=True, ml=True,
                     output_type=types, fake_predict=real_hook(), store=store, spans=spans)
    sec = time.perf_counter() - t0
    got = counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    t0 = time.perf_counter()
    totalsegmentator(root / "series", root / "dcm_cpu", task="total", fast=True, ml=True,
                     output_type=types, fake_predict=anatomy.fake_predict_factory(),
                     store=store, device="cpu")
    cpu_s = time.perf_counter() - t0
    out, out_cpu = root / "dcm_gpu", root / "dcm_cpu"
    labels_img = nifti.load(out / "total_segmentation.nii.gz")
    labels = np.asarray(labels_img.data)
    label_map = labels_img.get_label_map()
    seg_ds = dicom.dcmread(out / "total_segmentation_seg.dcm")
    back, seg_names = dicom_seg.read_seg_labelmap(seg_ds)
    present = sorted(int(v) for v in np.unique(labels) if v and int(v) in label_map)
    expect = np.zeros(labels.shape, np.uint16)
    for i, lb in enumerate(present, start=1):
        expect[labels == lb] = i
    zs = np.flatnonzero(expect.any(axis=(0, 1)))
    seg_equal = back.shape == expect[:, :, zs].shape and \
        bool(np.array_equal(back, expect[:, :, zs]))
    _, headers = dicom_io.sorted_series_headers(root / "series")
    rt = dicom.dcmread(out / "total_segmentation_rtstruct.dcm")
    rt_checks = _rtstruct_checks(rt, labels, label_map, headers)
    _same_dicom(seg_ds, dicom.dcmread(out_cpu / "total_segmentation_seg.dcm"))
    _same_dicom(rt, dicom.dcmread(out_cpu / "total_segmentation_rtstruct.dcm"))
    nifti_same = (out / "total_segmentation.nii.gz").read_bytes() == \
        (out_cpu / "total_segmentation.nii.gz").read_bytes()
    res["dicom"] = {
        "shape": list(labels.shape), "sec": sec, "cpu_s": cpu_s, "peak_mem_gib": peak,
        "series_write_s": series_write_s, "spans": spans,
        "writers_s": {k: spans.get(k) for k in ("save_nifti", "save_dicom_seg",
                                                "save_dicom_rtstruct", "contours")},
        "tiles": spans["tiles"], "launches": got, "segments": len(seg_names),
        "seg_frames": int(seg_ds.NumberOfFrames),
        "seg_bytes": (out / "total_segmentation_seg.dcm").stat().st_size,
        "rtstruct_bytes": (out / "total_segmentation_rtstruct.dcm").stat().st_size,
        "seg_equal_nifti": seg_equal, "nifti_identical_cpu": nifti_same, **rt_checks,
        "part_s": time.perf_counter() - t_part}
    emit({"phase": "api", "part": "dicom", **res["dicom"]})
    assert got == _want_launches(spans["tiles"]), got
    assert seg_equal and nifti_same and len(seg_names) == len(present) > 10

    # --- (c) --radiomics through the CLI and the anatomy hook. The phantom's
    # lungs hold no fat, so ct_pfav.nii.gz is empty on fine grids and the
    # radiomics pass raises on it, as the reference's does (ROADMAP Queue 3);
    # on this coarse grid the nearest back-resample puts lung labels on fat
    t_part = time.perf_counter()
    small, small_sp = (96, 96, 32), (3.5, 3.5, 9.0)
    nifti.save(nifti.NiftiImage(data=anatomy.synth_ct(small, small_sp),
                                affine=np.diag([*small_sp, 1.0])), root / "small.nii.gz")
    env_before = dict(os.environ)
    os.environ.clear()
    os.environ.update(_cli_env(BOA_TEST_ANATOMY="1", SKIP_CONTRAST_INFORMATION="1",
                               BOA_TPU_CONFIG_DIR=str(root / "cfg")))
    try:
        reset()
        t0 = time.perf_counter()
        cli.run(["-i", str(root / "small.nii.gz"), "-o", str(root / "cli"), "-m", "total",
                 "--fast-total", "--radiomics"])
        sec = time.perf_counter() - t0
    finally:
        os.environ.clear()
        os.environ.update(env_before)
    rad = json.loads((root / "cli" / "statistics_radiomics.json").read_text())
    res["cli"] = {"shape": list(small), "sec": sec, "files": sorted(rad),
                  "total_present": sum(1 for v in rad["total"].values() if v.get("present")),
                  "launches": counts(), "part_s": time.perf_counter() - t_part}
    emit({"phase": "api", "part": "cli", **res["cli"]})
    assert sorted(rad) == ["ct_pfav", "total"] and res["cli"]["total_present"] > 20
    tmp_dir.cleanup()
    res["phase_s"] = time.perf_counter() - t_phase
    emit({"phase": "api", "part": "done", "phase_s": res["phase_s"],
          "checkpoint_loads": store.loads})
    return res


# ---------------------------------------------------------------------------
# engine: the model-folder predictor on real-format .pth checkpoints
# ---------------------------------------------------------------------------

# at 3 mm: 4 tiles of 128^3 at step 0.5 (96 slices, cut from 160, and 192
# columns, cut from 224, for the script's time limit)
ENGINE_CASE = (192, 192, 96)
ENGINE_TILES = 4
ENGINE_MIRRORS = 8              # nnUNetTrainer's mirror axes (0, 1, 2): 2^3 flips
RESENC_M = dict(features=(32, 64, 128, 256, 320, 320), blocks=(1, 3, 4, 6, 6, 6))
TWO_D = dict(features=(32, 64, 128, 256, 512, 512, 512, 512), patch=(512, 512),
             spacing=(0.8, 0.8), case=(512, 512, 24))


def _engine_plans(features, patch, spacing, residual_blocks=None):
    """plans.json / dataset.json of a 118-class model: PlainConvUNet, or
    nnU-Net's ResEnc layout (`n_blocks_per_stage`, a one-conv decoder) as
    the reference's planner writes it; a 2-element patch is a 2d plan."""
    from boa_tpu_torch.plans.plans import synthetic_plans

    mp = synthetic_plans(num_classes=118, patch_size=(128, 128, 128),
                         spacing=(3.0, 3.0, 3.0), features=features)
    conf = mp.plans["configurations"].pop("3d_fullres")
    n = len(features)
    kw = conf["architecture"]["arch_kwargs"]
    conf["patch_size"], conf["spacing"] = list(patch), list(spacing)
    if len(patch) == 2:
        kw["kernel_sizes"] = [[3, 3]] * n
        kw["strides"] = [[1, 1]] + [[2, 2]] * (n - 1)
    if residual_blocks is not None:
        conf["architecture"]["network_class_name"] = (
            "dynamic_network_architectures.architectures.residual_unet.ResidualEncoderUNet")
        kw["n_blocks_per_stage"] = list(residual_blocks)
        kw["n_conv_per_stage_decoder"] = [1] * (n - 1)
        del kw["n_conv_per_stage"]
    name = "2d" if len(patch) == 2 else "3d_fullres"
    mp.plans["configurations"][name] = conf
    return mp.plans, mp.dataset, name


def _engine_folder(root, task_id: int, plans: dict, dataset: dict, conf: str,
                   folds: int, seed: int):
    """An nnU-Net results folder whose folds hold real-format
    `checkpoint_final.pth` files (`testing/nnunet_checkpoint.py`) of random
    weights from `seed` + fold, every fold's last head biased by the same
    N(0, 3) draw from seed 7 (the bench's trick for coherent labels from
    random weights; one draw, so that the fold mean keeps its spread)."""
    from boa_tpu_torch.plans.plans import ModelPlans
    from boa_tpu_torch.testing.nnunet_checkpoint import save_checkpoint
    from boa_tpu_torch.weights.store import init_params_numpy

    mdir = root / f"Dataset{task_id:03d}_engine" / f"nnUNetTrainer__nnUNetPlans__{conf}"
    mdir.mkdir(parents=True)
    (mdir / "plans.json").write_text(json.dumps(plans))
    (mdir / "dataset.json").write_text(json.dumps(dataset))
    cfg = ModelPlans(plans, dataset, conf).arch_config()
    for f in range(folds):
        params = init_params_numpy(cfg, seed + f)
        head = params["seg_heads"][-1]
        head["b"] = head["b"] + np.random.default_rng(7).normal(
            0, 3.0, head["b"].shape).astype(np.float32)
        save_checkpoint(mdir / f"fold_{f}" / "checkpoint_final.pth", params, cfg,
                        configuration=conf, fold=f, plans=plans, dataset_json=dataset)
    return mdir, cfg


def _leaves(tree) -> list:
    """The arrays of a parameter pytree, in a fixed order."""
    if isinstance(tree, dict):
        return [a for k in sorted(tree) for a in _leaves(tree[k])]
    if isinstance(tree, list):
        return [a for v in tree for a in _leaves(v)]
    return [tree]


def _engine_case(folder, shape, spacing, name="case"):
    from boa_tpu_torch.io import nifti

    img = _bench_ct(shape, spacing)
    folder.mkdir(parents=True, exist_ok=True)
    nifti.save(img, folder / f"{name}_0000.nii.gz")
    return img


def _counting_forwards(calls: list):
    """Count the network forwards (and the samples each carries) from the
    model's side while a predict runs: restores the method on exit."""
    import contextlib

    from boa_tpu_torch.models import unet as tu

    @contextlib.contextmanager
    def counting():
        orig = tu.PlainConvUNet.forward

        def forward(self, x, *a, **k):
            calls.append(int(x.shape[0]))
            return orig(self, x, *a, **k)
        tu.PlainConvUNet.forward = forward
        try:
            yield
        finally:
            tu.PlainConvUNet.forward = orig
    return counting()


def _plain_composite(rc):
    """Run every row-conv forward on the plain composite (`rc.PLAIN`: the
    kernels' plain versions, sums in a fixed order) while a predict runs;
    restores the method on exit."""
    import contextlib

    from boa_tpu_torch.models import unet as tu

    @contextlib.contextmanager
    def plain():
        orig = tu.PlainConvUNet.forward

        def forward(self, x, ops=None, all_heads=False):
            return orig(self, x, rc.PLAIN, all_heads)
        tu.PlainConvUNet.forward = forward
        try:
            yield
        finally:
            tu.PlainConvUNet.forward = orig
    return plain()


def _eager_check(torch, mdir, conf, case_dir, out_dir) -> dict:
    """`predict_folder` on one fold without TTA in bf16 (eager: no row-conv
    launch), its seconds and peak memory, against the same case through a
    float32 Predictor on the card; the bf16 forward's and the fp32 forward's
    ms on the case's tile."""
    from boa_tpu_torch.engine import predict as ep
    from boa_tpu_torch.inference.predictor import Predictor, _normalize
    from boa_tpu_torch.io import nifti
    from boa_tpu_torch.models.unet import cast_model
    from boa_tpu_torch.ops import pallas_conv as pc
    from boa_tpu_torch.ops import rowconv as rc

    plans, folds = ep.load_model_folder(mdir, [0], configuration=conf)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    rc.reset_launches()
    pc.reset_launches()
    spans: dict = {}
    t0 = time.perf_counter()
    written = ep.predict_folder(case_dir, out_dir, model_dir=mdir, configuration=conf,
                                folds=[0], disable_tta=True, spans=spans)
    sec = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    launches = dict(rc.LAUNCHES, **pc.LAUNCHES)
    seg = np.asarray(nifti.load(written[0]).data)
    img = nifti.load(next(case_dir.glob("*.nii.gz")))
    fp32 = Predictor(plans=plans, fold_params=folds, compute_dtype="float32",
                     device="cuda")
    ref = fp32.predict(np.asarray(img.data), img.zooms)
    # the forward alone on the case's (only) tile, bf16 and fp32
    x = _normalize(torch.as_tensor(np.asarray(img.data)[None], dtype=torch.float32,
                                   device="cuda"),
                   [plans.channel_intensity_properties(0)], plans.normalization_schemes)
    x = x.permute(1, 2, 3, 0)[None]
    model = fp32._cast[0]
    bf16 = cast_model(model, torch.bfloat16)
    with torch.no_grad():
        ms_bf16 = time_ms(torch, lambda: bf16(x.bfloat16()), 3)
        ms_fp32 = time_ms(torch, lambda: model(x), 2)
    res = {"shape": list(seg.shape), "tiles": fp32.n_tiles, "sec": sec,
           "spans": spans, "peak_gib": peak, "launches": launches,
           "argmax_agree_fp32": float((seg == ref).mean()),
           "classes_present": int(np.unique(seg).size),
           "forward_ms_bf16": ms_bf16, "forward_ms_fp32": ms_fp32,
           "params_m": sum(p.numel() for p in model.parameters()) / 1e6}
    del fp32, model, bf16, x
    torch.cuda.empty_cache()
    assert seg.shape == tuple(img.data.shape) and res["tiles"] == 1
    assert all(v == 0 for v in launches.values()), launches
    if res["argmax_agree_fp32"] <= 0.99:
        raise AssertionError(f"bf16 against fp32 {res['argmax_agree_fp32']}")
    return res


def phase_engine(torch, rc, pc) -> dict:
    """The model-folder predictor (`python -m boa_tpu_torch.engine.predict`)
    on real-format nnU-Net checkpoints at full width, weights random from
    fixed seeds: (a) total_fast's network (6-stage PlainConvUNet 32->320,
    118 classes, 128^3 patch, 3 mm plan) as a results folder whose two folds
    hold `checkpoint_final.pth`, one 192x192x96 case at 3 mm,
    nnUNetTrainer's mirror axes, `-f 0 1 -step_size 0.5
    --save_probabilities`: the folds converted (and cached as .npz), the
    cached load, the predict with its launches (K1/K2/K3 = (4, 1, 1) per
    network forward, 4 tiles x 2 folds forwards of the 8 flips as one
    batch: 64 network evaluations), the labels an argmax of the .npz; the
    folder without probabilities twice in this process, then imported into
    a store (the same parameters, bit for bit) and `-d` run as a
    subprocess: labels within 1e-4 of the folder's (two runs of one model
    differ where the kernels' atomic sums round apart); the kernel
    composite against the plain composite on one tile. (b) nnU-Net's ResEnc M layout at full width on one 128^3 case and
    (c) an 8-stage 2d net (32->512, 512x512 patch, 0.8 mm) on a
    512x512x24 slice stack, both one fold without TTA, eager in bf16:
    labels against a float32 Predictor on the card > 0.99, seconds, peak
    memory and the forward's ms."""
    from boa_tpu_torch.engine import predict as ep
    from boa_tpu_torch.inference.predictor import _normalize
    from boa_tpu_torch.inference.sliding_window import mirror_combos
    from boa_tpu_torch.io import nifti
    from boa_tpu_torch.models.unet import cast_model
    from boa_tpu_torch.plans.plans import ModelPlans
    from boa_tpu_torch.train.variants import get_variant
    from boa_tpu_torch.weights import convert as cv
    from boa_tpu_torch.weights.store import ModelStore, import_torch_model_folder
    from pathlib import Path

    t_phase = time.perf_counter()
    tmp_dir = tempfile.TemporaryDirectory()
    root = Path(tmp_dir.name)
    res: dict = {}

    # ---- (a) total_fast's network from .pth, two folds, mirror TTA, K1-K3
    t0 = time.perf_counter()
    plans_d, dataset, conf = _engine_plans(TOTAL_FAST_FEATURES, (128, 128, 128),
                                           (3.0, 3.0, 3.0))
    mdir, cfg = _engine_folder(root / "results", 297, plans_d, dataset, conf, 2, 0)
    case_dir = root / "cases"
    img = _engine_case(case_dir, ENGINE_CASE, (3.0, 3.0, 3.0))
    write_s = time.perf_counter() - t0
    pth_mb = sum(p.stat().st_size for p in mdir.glob("fold_*/*.pth")) / 2 ** 20
    t0 = time.perf_counter()
    ep.load_model_folder(mdir, [0, 1])                 # .pth -> pytree, .npz cached
    convert_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, folds = ep.load_model_folder(mdir, [0, 1])      # the cached .npz
    npz_load_s = time.perf_counter() - t0
    argv = ["-i", str(case_dir), "-o", str(root / "preds"), "-m", str(mdir),
            "-f", "0", "1", "-step_size", "0.5", "--save_probabilities"]
    calls: list = []
    spans: dict = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rc.reset_launches()
    pc.reset_launches()
    t0 = time.perf_counter()
    with _counting_forwards(calls):
        # what `python -m boa_tpu_torch.engine.predict <argv>` runs, with spans
        ep.predict_folder(case_dir, root / "preds", model_dir=mdir, folds=[0, 1],
                          step_size=0.5, save_probabilities=True, spans=spans)
    predict_s = time.perf_counter() - t0
    launches = dict(rc.LAUNCHES, **pc.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    fwd = len(calls)
    want = _want_launches(fwd, fwd * sum(
        pc._split_plan(128, 128, 128, cin, 32, pc._sms(torch.device("cuda")), ENGINE_MIRRORS)[0] > 1
        for cin in (32, 64, 32)))
    seg_f = root / "preds" / "case.nii.gz"
    seg = np.asarray(nifti.load(seg_f).data)
    t0 = time.perf_counter()
    probs = np.load(root / "preds" / "case.npz")["probabilities"]
    npz_read_s = time.perf_counter() - t0
    am = np.argmax(probs, 0)
    diff = am != seg
    at_label = np.take_along_axis(probs, seg[None].astype(np.int64), 0)[0]
    ties = int(diff.sum())
    ties_ok = bool(np.array_equal(at_label[diff], probs.max(0)[diff]))
    del probs, am, at_label
    res["pth"] = {
        "case": list(ENGINE_CASE), "pth_mib": pth_mb, "write_s": write_s,
        "convert_s": convert_s, "npz_load_s": npz_load_s, "predict_s": predict_s,
        "spans": spans, "peak_gib": peak, "forwards": fwd,
        "samples": sum(calls), "launches": launches,
        "npz_read_s": npz_read_s, "argmax_ties_float16": ties,
        "classes_present": int(np.unique(seg).size)}
    emit({"phase": "engine", "part": "pth", **res["pth"]})
    assert seg.shape == ENGINE_CASE and sum(calls) == ENGINE_TILES * 2 * ENGINE_MIRRORS, calls
    assert fwd == ENGINE_TILES * 2 and launches == want, (launches, want)
    # the labels are an argmax of the .npz: where np.argmax differs, the
    # label's float16 probability ties the maximum
    assert ties_ok, ties

    # the same folder without probabilities (the fused path), twice in this
    # process; then into a store and `-d` as the command line, in a subprocess
    labels = {}
    for run in ("m1", "m2"):
        t0 = time.perf_counter()
        ep.predict_folder(case_dir, root / f"preds_{run}", model_dir=mdir, folds=[0, 1],
                          step_size=0.5)
        labels[run] = (time.perf_counter() - t0, root / f"preds_{run}" / "case.nii.gz")
    t0 = time.perf_counter()
    import_torch_model_folder(mdir, root / "store")
    import_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cmd = [sys.executable, "-m", "boa_tpu_torch.engine.predict", "-i", str(case_dir),
           "-o", str(root / "preds_d"), "-d", "297", "-f", "0", "1", "-step_size", "0.5"]
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                       cwd=os.path.dirname(os.path.abspath(__file__)),
                       env=_cli_env(BOA_WEIGHTS_PATH=str(root / "store")))
    cmd_s = time.perf_counter() - t0
    assert r.returncode == 0, r.stderr[-3000:]
    m1, m2, d = (np.asarray(nifti.load(f).data) for f in
                 (labels["m1"][1], labels["m2"][1], root / "preds_d" / "case.nii.gz"))
    # the store's folds are the folder's, bit for bit
    store_dir = root / "store" / mdir.parent.name / mdir.name
    same_params = all(
        np.array_equal(a, b) and a.dtype == b.dtype for f in (0, 1) for a, b in zip(
            _leaves(cv.load_params_npz(mdir / f"fold_{f}" / "checkpoint_final.npz")),
            _leaves(cv.load_params_npz(store_dir / f"fold_{f}" / "checkpoint_final.npz")),
            strict=True))
    res["store"] = {
        "import_s": import_s, "command_s": cmd_s, "fused_predict_s": labels["m1"][0],
        "fused_predict_again_s": labels["m2"][0],
        "d_bytes_equal_m": (root / "preds_d" / "case.nii.gz").read_bytes()
        == labels["m1"][1].read_bytes(),
        "voxels_d_vs_m": int((d != m1).sum()), "voxels_m_vs_m_again": int((m2 != m1).sum()),
        "voxels_probs_path_vs_fused": int((seg != m1).sum()),
        "store_params_bit_identical": same_params}
    emit({"phase": "engine", "part": "store", **res["store"]})
    # K1's and K2's instance-norm sums are atomicAdds, so two runs of one
    # model on the card round differently at a few voxels (50-158 of 6.9 M
    # on an H100 80GB HBM3, 2.3e-5 at most): `-d` is held to the folder
    # form at 1e-4
    assert same_params
    assert (d == m1).mean() > 1 - 1e-4 and (m2 == m1).mean() > 1 - 1e-4
    assert (seg == m1).mean() > 0.99

    # `-m` and `-d` once more in this process with the network on the plain
    # composite: the same code path but for the sums' order, so equal bytes
    # here put the differences above on the kernels' atomic sums
    plain_s = {}
    rc.reset_launches()
    pc.reset_launches()
    with _plain_composite(rc):
        for run, kw in (("pm", {"model_dir": mdir}),
                        ("pd", {"task_id": 297, "store": ModelStore(root / "store")})):
            t0 = time.perf_counter()
            ep.predict_folder(case_dir, root / f"preds_{run}", folds=[0, 1],
                              step_size=0.5, **kw)
            plain_s[run] = time.perf_counter() - t0
    plain_launches = dict(rc.LAUNCHES, **pc.LAUNCHES)
    pm_f, pd_f = (root / f"preds_{run}" / "case.nii.gz" for run in ("pm", "pd"))
    pm = np.asarray(nifti.load(pm_f).data)
    res["plain"] = {"predict_m_s": plain_s["pm"], "predict_d_s": plain_s["pd"],
                    "launches": plain_launches,
                    "d_bytes_equal_m": pd_f.read_bytes() == pm_f.read_bytes(),
                    "voxels_plain_vs_kernels": int((pm != m1).sum())}
    emit({"phase": "engine", "part": "plain", **res["plain"]})
    assert all(n == 0 for n in plain_launches.values()), plain_launches
    assert res["plain"]["d_bytes_equal_m"], res["plain"]
    assert (pm == m1).mean() > 0.99

    # the kernel composite against the plain composite on the batch the path
    # sends: the case's first tile and its 7 flips (`_forward_tta`'s batch)
    model = cast_model(cv.params_from_numpy(folds[0], cfg, "cuda"), torch.bfloat16)
    plans = ModelPlans(plans_d, dataset, conf)
    v = _normalize(torch.as_tensor(np.asarray(img.data)[None], dtype=torch.float32,
                                   device="cuda"),
                   [plans.channel_intensity_properties(0)], plans.normalization_schemes)
    x = v[0, :128, :128, :128][None, ..., None].bfloat16()
    axes = get_variant("nnUNetTrainer").mirror_axes
    xs = torch.cat([x] + [torch.flip(x, c) for c in mirror_combos(axes)]).contiguous()
    del v, x
    with torch.no_grad():
        got = model(xs, rc.KERNELS)
        ref = model(xs, rc.PLAIN)
        kernels_again = bool(torch.equal(got, model(xs, rc.KERNELS)))
        plain_again = bool(torch.equal(ref, model(xs, rc.PLAIN)))
        ms_kernels = time_ms(torch, lambda: model(xs, rc.KERNELS), 3)
    samples = []
    for g, r in zip(got, ref):
        g, r = g.float(), r.float()
        samples.append({"argmax_agree": float((g.argmax(-1) == r.argmax(-1)).float().mean()),
                        "max_abs_err": float((g - r).abs().max()),
                        "logit_absmax": float(r.abs().max()),
                        "finite": bool(torch.isfinite(g).all())})
    res["tile"] = {"batch": int(xs.shape[0]), "samples": samples,
                   "argmax_agree": min(c["argmax_agree"] for c in samples),
                   "max_abs_err": max(c["max_abs_err"] for c in samples),
                   "max_rel_err": max(c["max_abs_err"] / c["logit_absmax"] for c in samples),
                   "kernels_repeat_bit_equal": kernels_again,
                   "plain_repeat_bit_equal": plain_again, "ms_batch_kernels": ms_kernels}
    emit({"phase": "engine", "part": "tile", **res["tile"]})
    del model, got, ref, xs, folds
    torch.cuda.empty_cache()
    assert res["tile"]["batch"] == ENGINE_MIRRORS and plain_again, res["tile"]
    if not all(c["finite"] and c["argmax_agree"] > 0.99
               and c["max_abs_err"] <= 2e-2 * c["logit_absmax"] for c in samples):
        raise AssertionError(f"engine tile composite {res['tile']}")

    # ---- (b) ResEnc M at full width, eager
    plans_d, dataset, conf = _engine_plans(RESENC_M["features"], (128, 128, 128),
                                           (1.5, 1.5, 1.5), RESENC_M["blocks"])
    mdir, _ = _engine_folder(root / "results", 298, plans_d, dataset, conf, 1, 10)
    _engine_case(root / "cases_resenc", (128, 128, 128), (1.5, 1.5, 1.5))
    res["resenc"] = _eager_check(torch, mdir, conf, root / "cases_resenc",
                                 root / "preds_resenc")
    emit({"phase": "engine", "part": "resenc", **res["resenc"]})

    # ---- (c) 2d at full width on a slice stack, eager
    plans_d, dataset, conf = _engine_plans(TWO_D["features"], TWO_D["patch"],
                                           TWO_D["spacing"])
    mdir, _ = _engine_folder(root / "results", 299, plans_d, dataset, conf, 1, 20)
    _engine_case(root / "cases_2d", TWO_D["case"], TWO_D["spacing"] + (3.0,))
    res["two_d"] = _eager_check(torch, mdir, conf, root / "cases_2d", root / "preds_2d")
    emit({"phase": "engine", "part": "two_d", **res["two_d"]})

    tmp_dir.cleanup()
    res["phase_s"] = time.perf_counter() - t_phase
    emit({"phase": "engine", "part": "done", "phase_s": res["phase_s"]})
    return res


# ---------------------------------------------------------------------------
# tools: the TotalSegmentator tools and the registration on the card
# ---------------------------------------------------------------------------

TOOL_MODELS = (   # task id, folder name, trainer, class map, plan spacing
    (552, "ventricle_parts", "nnUNetTrainerNoMirroring", "ventricle_parts",
     (0.4384765625, 0.4345703125, 1.0)),
    (300, "body_6mm", "nnUNetTrainer", "body", (6.0, 6.0, 6.0)),
    (852, "total_mr_3mm", "nnUNetTrainer_2000epochs_NoMirroring", "total_mr", (3.0, 3.0, 3.0)),
)


def _perturbed_atlas(atlas, deg, scale, shift):
    """`atlas` resampled through a known in-plane rotation, scale and shift
    (moving(x) = atlas(A (x - c) + c + shift)), the true fixed -> moving
    voxel map and the centre c."""
    from scipy import ndimage as ndi

    th = np.radians(deg)
    a = np.array([[np.cos(th), -np.sin(th), 0.0], [np.sin(th), np.cos(th), 0.0],
                  [0.0, 0.0, 1.0]]) * scale
    c = (np.asarray(atlas.shape, np.float64) - 1) / 2
    offset = c + np.asarray(shift) - a @ c
    moving = ndi.affine_transform(atlas, a, offset=offset, order=1)
    ainv = np.linalg.inv(a)
    return moving, (lambda x: ainv @ (x - offset)), c


def _tool_runs(torch, rc, pc, run) -> dict:
    """`run(mode)` on the kernels (launches counted from 0, network forwards
    counted from the model's side) and again on the plain composite: each
    run's result, seconds, launches and forwards."""
    out = {}
    for mode in ("kernels", "plain"):
        calls: list = []
        rc.reset_launches()
        pc.reset_launches()
        ctx = _plain_composite(rc) if mode == "plain" else _counting_forwards(calls)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with ctx:
            result = run(mode)
        torch.cuda.synchronize()
        out[mode] = {"result": result, "sec": time.perf_counter() - t0,
                     "launches": dict(rc.LAUNCHES, **pc.LAUNCHES), "forwards": len(calls)}
    return out


def phase_tools(torch, rc, pc) -> dict:
    """The TotalSegmentator tools on the card. (a) The registration
    (`ops/registration.py`): the 1 mm atlas against a known perturbation of
    itself (10 degrees in-plane, scale 1.05, a shift of (3, -2, 1.5) voxels),
    levels (4, 2), 150 steps each: NCC > 0.9 and the mean error at six
    landmarks < 2 voxels (tests/test_registration.py's bars), the seconds of
    each level; at fixed parameters on the level-4 volumes, the matrix card
    against CPU at rtol 1e-6, and one `ncc_loss` and its gradient with
    respect to that matrix at rtol 1e-4. (b) The commands on the
    card with synthetic full-width models (ventricle_parts, body 6 mm,
    total_mr 3 mm beside total_fast in its store): `evans_index.main` on a
    1 mm head CT (the atlas's central 128 x 160 x 96 mm), `crop_to_body.main`,
    `get_modality.main` with and without -n and `get_phase.main` on a
    256 x 256 x 100 anatomy phantom, each run on K1-K3 (launches (4, 1, 1)
    per network forward) and again on the plain composite (no launch): the
    same Evans JSON (the reference's command never finds the horns in the
    ventricle_parts map, ROADMAP Queue 3), the same bbox, the same
    modality, pi_time within 0.5, each JSON written. Before them, while a
    host thread writes the models, `evans_index` itself on the atlas at 2 mm
    turned 10 degrees, with the CT (60 steps a level, as the reference's
    test), so the registration runs on the card,
    against the same call on the CPU: both succeed, the index within 0.01,
    the overview PNG written."""
    from pathlib import Path

    from scipy import ndimage as ndi

    from boa_tpu_torch.io import nifti
    from boa_tpu_torch.ops import registration as reg
    from boa_tpu_torch.tasks.class_maps import get_class_map
    from boa_tpu_torch.testing import anatomy
    from boa_tpu_torch.tools import crop_to_body, evans_index, get_modality, get_phase
    from boa_tpu_torch.weights.store import create_synthetic_model

    res = {}
    t_phase = time.perf_counter()
    atlas_img = nifti.load(evans_index._ATLAS_PATH)
    atlas = np.clip(np.asarray(atlas_img.data, np.float32), 0.0, 100.0)

    # --- (a) the registration at 1 mm on the card
    t_part = time.perf_counter()
    moving, r_true, c = _perturbed_atlas(atlas, 10.0, 1.05, (3.0, -2.0, 1.5))
    spans: dict = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, mat, ncc = reg.register_affine(atlas, moving, levels=(4, 2), steps_per_level=150,
                                           device="cuda", spans=spans)
    reg_s = time.perf_counter() - t0
    marks = [c, c + (30, 0, 0), c - (30, 0, 0), c + (0, 30, 0), c + (0, 0, 24),
             c + (20, 20, -16)]
    errs = [float(np.linalg.norm(mat[:3, :3] @ m + mat[:3, 3] - r_true(m))) for m in marks]
    # one loss and its gradient at fixed parameters on the level-4 volumes.
    # The loss is piecewise linear in the sample positions, so its gradient
    # jumps where a voxel crosses a cell of the trilinear gather: the card's
    # sin/cos/exp round the matrix an ulp away from the CPU's, which moves
    # the parameters' gradient by up to ~1e-3 relative (as moving the CPU's
    # own matrix by one ulp does, printed as `grad_ulp_shift_rel`). So the
    # 1e-4 bar holds the gradient with respect to one matrix, the CPU's,
    # given to both devices, and the matrices themselves at 1e-6 relative.
    fixed4 = reg._downsample(torch.from_numpy(atlas), 4)
    moving4 = reg._downsample(torch.from_numpy(moving.astype(np.float32)), 4)
    at = [np.array(v, np.float32) for v in ((0.8, -0.5, 0.3), (0.01, -0.02, 0.15),
                                            (0.04, 0.03, 0.05), (0.0, 0.0, 0.0))]

    def loss_grad(dev, matrix=None, scale=1.0):
        """(loss, gradient) with respect to the parameters, or to `matrix`."""
        leaves = reg.AffineParams(*(torch.tensor(v, device=dev, requires_grad=True)
                                    for v in at))
        m = reg.params_to_matrix(leaves, fixed4.shape, moving4.shape) * scale
        if matrix is not None:
            m = matrix.clone().to(dev).requires_grad_(True)
        loss = reg.ncc_loss(fixed4.to(dev),
                            reg.affine_warp(moving4.to(dev), m, tuple(fixed4.shape)))
        loss.backward()
        g = m.grad if matrix is not None else torch.cat([t.grad for t in leaves])
        return loss.detach().item(), g.detach().cpu().numpy().ravel(), m.detach().cpu()

    lp = {dev: loss_grad(dev) for dev in ("cuda", "cpu")}
    shifted = loss_grad("cpu", scale=1.0 + 1.2e-7)
    lm = {dev: loss_grad(dev, matrix=lp["cpu"][2]) for dev in ("cuda", "cpu")}
    loss_rel = abs(lm["cuda"][0] - lm["cpu"][0]) / abs(lm["cpu"][0])
    res["registration"] = {
        "shape": list(atlas.shape), "ncc": ncc, "landmark_err_vox": errs,
        "mean_landmark_err_vox": float(np.mean(errs)), "sec": reg_s, "level_s": spans,
        "step_ms": {k: v / 150 * 1e3 for k, v in spans.items()},
        "rotation_deg": np.degrees(np.asarray(params.rotation)).tolist(),
        "scale": np.exp(np.asarray(params.log_scale)).tolist(),
        "matrix_max_err": float((lp["cuda"][2] - lp["cpu"][2]).abs().max()),
        "ncc_loss_card": lm["cuda"][0], "ncc_loss_cpu": lm["cpu"][0],
        "ncc_loss_rel_err": loss_rel,
        "grad_matrix_max_rel": float(np.max(np.abs(lm["cuda"][1] - lm["cpu"][1])
                                            / np.maximum(np.abs(lm["cpu"][1]), 1e-12))),
        "grad_params_max_rel": float(np.max(np.abs(lp["cuda"][1] - lp["cpu"][1])
                                            / np.abs(lp["cpu"][1]))),
        "grad_ulp_shift_rel": float(np.max(np.abs(shifted[1] - lp["cpu"][1])
                                           / np.abs(lp["cpu"][1]))),
        "part_s": time.perf_counter() - t_part}
    emit({"phase": "tools", "part": "registration", **res["registration"]})
    assert ncc > 0.9 and float(np.mean(errs)) < 2.0, (ncc, errs)
    np.testing.assert_allclose(lp["cuda"][2].numpy(), lp["cpu"][2].numpy(), rtol=1e-6,
                               atol=1e-6)
    assert loss_rel <= 1e-4, loss_rel
    np.testing.assert_allclose(lm["cuda"][1], lm["cpu"][1], rtol=1e-4, atol=1e-7)

    # --- the tools' models, written on a host thread meanwhile
    from concurrent.futures import ThreadPoolExecutor

    store = _total_fast_store()

    def write_models():
        for tid, name, trainer, cmap, spacing in TOOL_MODELS:
            if not list(Path(store.root).glob(f"Dataset{tid:03d}_*")):
                # no head bias: it would write each 125 MB fold twice
                names = ["background"] + list(get_class_map(cmap).values())
                create_synthetic_model(store.root, tid, name, num_classes=len(names),
                                       trainer=trainer, patch_size=(128, 128, 128),
                                       spacing=spacing, features=TOTAL_FAST_FEATURES,
                                       label_names=names)

    t_models = time.perf_counter()
    pool = ThreadPoolExecutor(1)
    models = pool.submit(write_models)
    tmp_dir = tempfile.TemporaryDirectory()
    root = Path(tmp_dir.name)

    # --- evans_index with the CT: the registration on the card against the CPU
    atlas2 = ndi.zoom(np.asarray(atlas_img.data, np.float32), 0.5, order=1)
    vent = np.zeros(atlas2.shape, np.uint8)
    ax, ay, az = (s // 2 for s in atlas2.shape)
    vent[ax - 12:ax - 3, ay + 10, az] = 1
    vent[ax + 3:ax + 12, ay + 10, az] = 2
    rot = {k: ndi.rotate(v, 10.0, axes=(1, 0), reshape=False, order=o) for k, v, o in (
        ("ct", atlas2, 1), ("vent", vent, 0), ("brain", (atlas2 > 50.0).astype(np.uint8), 0))}
    ev = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        ev[dev] = evans_index.evans_index(
            rot["vent"], {1: "frontal_horn_left", 2: "frontal_horn_right"}, rot["brain"] > 0,
            (2.0, 2.0, 2.0), plot_file=root / f"evans_{dev}.png", ct=rot["ct"],
            atlas_data=atlas2, atlas_spacing=2.0, registration_steps=60, device=dev)
        ev[dev + "_s"] = time.perf_counter() - t0
    res["evans_index"] = {"card": ev["cuda"], "cpu": ev["cpu"], "card_s": ev["cuda_s"],
                          "cpu_s": ev["cpu_s"],
                          "png_bytes": (root / "evans_cuda.png").stat().st_size}
    emit({"phase": "tools", "part": "evans_index", **res["evans_index"]})
    assert ev["cuda"]["success"] and ev["cpu"]["success"]
    assert "atlas_registration" in ev["cuda"] and (root / "evans_cuda.png").exists()
    assert abs(ev["cuda"]["evans_index"] - ev["cpu"]["evans_index"]) <= 0.01
    # --- (b) the commands on K1-K3 and on the plain composite
    models.result()   # written while the evans_index check ran
    models_s = time.perf_counter() - t_models
    cx, cy, cz = (s // 2 for s in atlas.shape)
    head = np.asarray(atlas_img.data)[cx - 64:cx + 64, cy - 80:cy + 80, cz - 48:cz + 48]
    nifti.save(nifti.NiftiImage(data=np.ascontiguousarray(head), affine=np.eye(4)),
               root / "head.nii.gz")
    sp = (1.5, 1.5, 3.0)
    nifti.save(nifti.NiftiImage(data=anatomy.synth_ct((256, 256, 100), sp),
                                affine=np.diag([*sp, 1.0])), root / "ct.nii.gz")
    inner = getattr(store, "inner", store)

    def command(main, argv, out_json):
        def run(mode):
            main([*argv, "-o", str(root / f"{mode}_{out_json}")], store=inner)
            return json.loads((root / f"{mode}_{out_json}").read_text())
        return run

    def crop(mode):
        crop_to_body.main(["-i", str(root / "ct.nii.gz"), "-o", str(root / f"{mode}.nii.gz"),
                           "-q"], store=inner)
        return json.loads((root / f"{mode}_bbox.json").read_text())

    runs = {
        "evans": command(evans_index.main,
                         ["-i", str(root / "head.nii.gz"), "-p", str(root / "evans.png")],
                         "evans.json"),
        "crop_to_body": crop,
        "modality": command(get_modality.main, ["-i", str(root / "ct.nii.gz")],
                            "modality.json"),
        "modality_n": command(get_modality.main, ["-i", str(root / "ct.nii.gz"), "-n"],
                              "modality_n.json"),
        "phase": command(get_phase.main, ["-i", str(root / "ct.nii.gz")], "phase.json"),
    }
    launches = {k: 0 for k in REPLACES}
    for name, run in runs.items():
        r = _tool_runs(torch, rc, pc, run)
        k, p = r["kernels"], r["plain"]
        res[name] = {"sec": k["sec"], "plain_sec": p["sec"], "forwards": k["forwards"],
                     "launches": k["launches"], "result": k["result"],
                     "plain_result": p["result"]}
        emit({"phase": "tools", "part": name, **res[name]})
        assert k["launches"] == _want_launches(k["forwards"]), (name, k["launches"])
        assert sum(p["launches"].values()) == 0, (name, p["launches"])
        for kname in REPLACES:
            launches[kname] += k["launches"][kname]
    assert res["evans"]["result"] == res["evans"]["plain_result"]
    assert res["crop_to_body"]["result"] == res["crop_to_body"]["plain_result"]
    assert res["crop_to_body"]["result"]["original_shape"] == [256, 256, 100]
    for name in ("modality", "modality_n"):
        assert res[name]["result"]["modality"] == res[name]["plain_result"]["modality"]
    assert res["modality"]["forwards"] == 0
    assert min(res[n]["forwards"] for n in ("evans", "crop_to_body", "modality_n", "phase")) > 0
    assert abs(res["phase"]["result"]["pi_time"]
               - res["phase"]["plain_result"]["pi_time"]) <= 0.5

    pool.shutdown()
    tmp_dir.cleanup()
    res["launches"] = launches
    res["phase_s"] = time.perf_counter() - t_phase
    emit({"phase": "tools", "part": "done", "phase_s": res["phase_s"], "models_s": models_s,
          "launches": launches})
    return res


# ---------------------------------------------------------------------------
# serve: the study stream and the deploy-time warm-up
# ---------------------------------------------------------------------------

SERVE_SHAPE = (512, 512, 150)
SERVE_STUDIES = 5   # one of them truncated

# a fresh process: the first and second study of one file, after the
# warm-up command's entry and a warm-up for the study's own model-grid shape
# (its body-cropped extent), or without either
_FIRST_STUDY = r"""
import json, sys, time
import torch
from boa_tpu_torch import _build
from boa_tpu_torch.inference.pipeline import predict_image
from boa_tpu_torch.io import nifti
from boa_tpu_torch.ops import cropping
from boa_tpu_torch.serve import warmup
from boa_tpu_torch.weights.store import ModelStore

root, path, warm = sys.argv[1], sys.argv[2], sys.argv[3] == "warm"
store = ModelStore(root)
img = nifti.load(path)
out = {}
if warm:   # the command's entry over two z buckets, then the study's own shape
    t0 = time.perf_counter()
    warmup.main(["--task", "total", "--fast", "--xy", "512", "--z-range", "150", "200",
                 "--weights", root])
    out["command_s"] = time.perf_counter() - t0
    cropped, _ = cropping.body_crop_xy(img)
    t0 = time.perf_counter()
    out["warmup_s"] = warmup.warmup_task(store, "total", fast=True, xy=cropped.shape[:2],
                                         z_range=(img.shape[2], img.shape[2]),
                                         spacing=tuple(float(s) for s in img.zooms))
    out["warmup_total_s"] = time.perf_counter() - t0
for key in ("first_s", "second_s"):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    predict_image(img, "total", store, fast=True, bucket=64, device="cuda")
    torch.cuda.synchronize()
    out[key] = time.perf_counter() - t0
out["build_cached"] = _build.build_info.get("cached")
out["build_s"] = _build.build_info.get("seconds")
print(json.dumps(out))
"""


def phase_serve(torch, rc, pc) -> dict:
    """The serving layer on the card with the full-width total_fast store.
    (a) The stream: five 512x512x150 .nii.gz files (four anatomy phantoms
    and a truncated copy of the first) through `StreamRunner(task="total", fast=True)`
    (decode and write on host threads, the predict on this thread), after
    one warm-up study: four studies, the corrupt one failing alone, each
    study's labels against a serial `predict_image` of the same file: equal
    on the plain composite (the first study through both), and on the
    kernels, whose sums are atomic, apart at no more than 1e-4 of the
    voxels or three times the kernels' own run-to-run difference (the first
    study predicted twice); volumes per minute against the serial loop
    (load, predict, save one after the other), the launches (4, 1, 1) per
    network forward. (b) The warm-up: in a fresh process the command's
    entry (`warmup.main`, `--task total --fast --xy 512 --z-range 150 200`:
    two buckets) and a warm-up of the study's own shape, then the first and
    second study of one phantom, against a fresh process not warmed, with
    the kernel build's cache state; `--bake --stamp` twice in this process,
    the second returning without a launch."""
    from concurrent.futures import ThreadPoolExecutor
    from pathlib import Path

    from boa_tpu_torch.inference.pipeline import predict_image
    from boa_tpu_torch.io import nifti
    from boa_tpu_torch.serve import warmup
    from boa_tpu_torch.serve.stream import StreamRunner, StudyJob
    from boa_tpu_torch.testing import anatomy

    res = {}
    t_phase = time.perf_counter()
    store = _total_fast_store()
    inner = getattr(store, "inner", store)
    tmp_dir = tempfile.TemporaryDirectory()
    root = Path(tmp_dir.name)
    sp = (1.5, 1.5, 3.0)

    # --- (a) the stream against the serial loop
    t_part = time.perf_counter()

    def write(k):
        nifti.save(nifti.NiftiImage(data=anatomy.synth_ct(SERVE_SHAPE, sp, seed=k),
                                    affine=np.diag([*sp, 1.0])), root / f"s{k}.nii.gz")

    with ThreadPoolExecutor(SERVE_STUDIES) as ex:
        list(ex.map(write, [k for k in range(SERVE_STUDIES) if k != 3]))
    full = (root / "s0.nii.gz").read_bytes()
    (root / "s3.nii.gz").write_bytes(full[:len(full) // 2])
    write_s = time.perf_counter() - t_part
    jobs = [StudyJob(study_id=f"s{k}", input_path=root / f"s{k}.nii.gz",
                     output_dir=root / "stream" / f"s{k}") for k in range(SERVE_STUDIES)]
    runner = StreamRunner(store=inner, task="total", fast=True, device="cuda")
    runner.run(jobs[:1])   # warm: the weights and the shapes, as a served stream is
    rc.reset_launches()
    pc.reset_launches()
    calls: list = []
    with _counting_forwards(calls):
        stats = runner.run(jobs)
    launches = dict(rc.LAUNCHES, **pc.LAUNCHES)
    good = [k for k in range(SERVE_STUDIES) if k != 3]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    serial = {}
    for k in good:
        img = nifti.load(root / f"s{k}.nii.gz")
        r = predict_image(img, "total", inner, fast=True, bucket=64, device="cuda")
        nifti.save(r.seg, root / f"serial_s{k}.nii.gz")
        serial[k] = np.asarray(r.seg.data)
    serial_s = time.perf_counter() - t0
    differ = {}
    for k in good:
        got = np.asarray(nifti.load(root / "stream" / f"s{k}" / "total.nii.gz").data)
        differ[k] = float((got != serial[k]).mean())
    # the kernels' own run-to-run difference (their sums are atomic): the
    # first study once more; and the stream against the serial call on the
    # plain composite (fixed-order sums), where they must be equal
    img0 = nifti.load(root / "s0.nii.gz")
    rerun = predict_image(img0, "total", inner, fast=True, bucket=64, device="cuda")
    rerun_differ = float((np.asarray(rerun.seg.data) != serial[0]).mean())
    with _plain_composite(rc):
        StreamRunner(store=inner, task="total", fast=True, device="cuda").run(
            [StudyJob(study_id="plain", input_path=root / "s0.nii.gz",
                      output_dir=root / "plain")])
        plain = predict_image(img0, "total", inner, fast=True, bucket=64, device="cuda")
    plain_equal = bool(np.array_equal(
        np.asarray(nifti.load(root / "plain" / "total.nii.gz").data),
        np.asarray(plain.seg.data)))
    res["stream"] = {
        "shape": list(SERVE_SHAPE), "studies": SERVE_STUDIES, "n_studies": stats.n_studies,
        "stream_s": stats.total_s, "per_study_s": stats.per_study_s,
        "volumes_per_min": stats.volumes_per_min, "serial_s": serial_s,
        "serial_volumes_per_min": len(good) / serial_s * 60.0, "write_inputs_s": write_s,
        "forwards": len(calls), "launches": launches, "differ_share": differ,
        "rerun_differ_share": rerun_differ, "plain_stream_equal_serial": plain_equal,
        "plain_vs_kernels_differ_share": float(
            (np.asarray(plain.seg.data) != serial[0]).mean()),
        "classes_present": int(len(np.unique(serial[0]))),
        "part_s": time.perf_counter() - t_part}
    emit({"phase": "serve", "part": "stream", **res["stream"]})
    assert stats.n_studies == SERVE_STUDIES - 1, stats.n_studies
    assert not (root / "stream" / "s3").exists()
    assert len(calls) > 0 and launches == _want_launches(len(calls)), launches
    assert plain_equal
    # on the kernels the stream adds nothing to their run-to-run difference
    assert max(differ.values()) <= max(1e-4, 3 * rerun_differ), (differ, rerun_differ)

    # --- (b) the warm-up in fresh processes
    t_part = time.perf_counter()
    env = _cli_env(BOA_TPU_CONFIG_DIR=str(root / "cfg"), BOA_WEIGHTS_PATH=str(store.root))
    first = {}
    for mode in ("warm", "cold"):
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-c", _FIRST_STUDY, str(store.root),
                            str(root / "s0.nii.gz"), mode],
                           cwd=os.path.dirname(os.path.abspath(__file__)),
                           capture_output=True, text=True, env=env, timeout=600)
        assert r.returncode == 0, r.stderr[-3000:]
        out = r.stdout.strip().splitlines()
        first[mode] = dict(json.loads(out[-1]), process_s=time.perf_counter() - t0)
        if mode == "warm":
            warmed = [ln for ln in out if ln.startswith("warmed ")][-1]
    stamp = root / "warm.stamp"
    bake = []
    for _ in range(2):
        rc.reset_launches()
        pc.reset_launches()
        t0 = time.perf_counter()
        warmup.main(["--bake", "--stamp", str(stamp), "--xy", "512", "--z-range", "150", "150",
                     "--weights", str(store.root)])
        bake.append({"sec": time.perf_counter() - t0,
                     "launches": sum(dict(rc.LAUNCHES, **pc.LAUNCHES).values())})
    res["warmup"] = {"cli": warmed, "first_study": first,
                     "bake": bake, "part_s": time.perf_counter() - t_part}
    emit({"phase": "serve", "part": "warmup", **res["warmup"]})
    assert warmed.startswith("warmed 2 bucketed shapes"), warmed
    assert first["warm"]["build_cached"] and first["cold"]["build_cached"], first
    assert bake[0]["launches"] > 0 and bake[1]["launches"] == 0 and stamp.exists(), bake
    tmp_dir.cleanup()
    res["phase_s"] = time.perf_counter() - t_phase
    emit({"phase": "serve", "part": "done", "phase_s": res["phase_s"]})
    return res


PACS_MAX_ID = 41   # the stand-in monitoring DB's MAX(id)


def _pacs_server(handler):
    """A stdlib HTTP server on a free localhost port, served on a daemon
    thread; the caller shuts it down."""
    import threading
    from http.server import ThreadingHTTPServer

    srv = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


def _pacs_fakes(state: dict, share):
    """The deployment's services around the worker: Orthanc's REST API over
    `state["series"]` (id -> (simplified tags, {instance: bytes or path})),
    a STOW-RS receiver keeping its posts, and stand-in `orthanc` (Orthanc's
    embedded runtime, backed by the same data), `smbclient` (copies into the
    local folder `share`; only the network copy is replaced) and `psycopg2`
    (records every statement) modules. Returns (orthanc server, STOW server,
    {module name: stand-in})."""
    import json as _json
    import types
    from http.server import BaseHTTPRequestHandler
    from pathlib import Path

    def instance(inst):
        for tags, files in state["series"].values():
            if inst in files:
                data = files[inst]
                return tags, data if isinstance(data, bytes) else Path(data).read_bytes()
        raise KeyError(inst)

    def rest_get(path: str) -> bytes:
        parts = path.split("?")[0].split("/")
        if parts[1] == "series":
            return _json.dumps({"Instances": list(state["series"][parts[2]][1])}).encode()
        if parts[3] == "metadata":
            return _json.dumps({"CalledAET": "BOA"}).encode()
        if parts[3] == "simplified-tags":
            return _json.dumps(instance(parts[2])[0]).encode()
        if parts[3] == "file":
            return instance(parts[2])[1]
        raise KeyError(path)

    class Orthanc(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_GET(self):
            try:
                body = rest_get(self.path)
            except (KeyError, IndexError):
                self.send_response(404)
                self.end_headers()
                return
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_DELETE(self):
            state["deleted"].append(self.path)
            self.send_response(200)
            self.send_header("Content-Length", "0")
            self.end_headers()

    class Stow(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_POST(self):
            body = self.rfile.read(int(self.headers["Content-Length"]))
            state["stow"].append((self.path, self.headers["Content-Type"], body))
            self.send_response(200)
            self.send_header("Content-Length", "0")
            self.end_headers()

    orthanc = types.ModuleType("orthanc")
    orthanc.logs, orthanc.callbacks = [], []
    orthanc.LogWarning = orthanc.logs.append
    orthanc.ChangeType = types.SimpleNamespace(STABLE_SERIES=9)
    orthanc.RegisterOnChangeCallback = orthanc.callbacks.append
    orthanc.RestApiGet = lambda path: rest_get(path).decode()
    orthanc.RestApiDelete = state["deleted"].append

    def local(path: str) -> Path:
        return share.joinpath(*[p for p in path.replace("\\", "/").split("/") if p])

    smb = types.ModuleType("smbclient")
    smb_shutil = types.ModuleType("smbclient.shutil")
    smb.ClientConfig = lambda **kw: None
    smb.register_session = lambda server, **kw: None
    smb.delete_session = lambda server: None
    smb.makedirs = lambda path, exist_ok=False: local(path).mkdir(parents=True,
                                                                  exist_ok=exist_ok)
    smb_shutil.copy2 = lambda src, dst: shutil.copy2(src, local(dst))
    smb.shutil = smb_shutil

    class Cursor:
        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

        def execute(self, sql, values=None):
            state["sql"].append((sql, values))

        def fetchone(self):
            return (PACS_MAX_ID,)

    class Connection:
        def cursor(self):
            return Cursor()

        def commit(self):
            pass

        def rollback(self):
            state["rollbacks"] += 1

        def close(self):
            pass

    psycopg2 = types.ModuleType("psycopg2")
    psycopg2.connect = lambda **kw: Connection()
    return (_pacs_server(Orthanc), _pacs_server(Stow),
            {"orthanc": orthanc, "smbclient": smb, "smbclient.shutil": smb_shutil,
             "psycopg2": psycopg2})


def _pacs_rows(sql: list) -> list[dict]:
    """The upserted monitoring rows, as dicts, in order."""
    rows = []
    for statement, values in sql:
        if statement.startswith("INSERT INTO boa_entries ("):
            cols = statement.split("(", 1)[1].split(")", 1)[0].split(", ")
            rows.append(dict(zip(cols, values)))
    return rows


def _boa_entries_columns(repo) -> set:
    """The columns of deploy/init.sql's monitoring table."""
    text = (repo / "deploy" / "init.sql").read_text()
    body = text.split("CREATE TABLE boa_entries (", 1)[1].split(");", 1)[0]
    return {line.split()[0] for line in body.strip().splitlines()
            if line.strip() and not line.strip().startswith("UNIQUE")}


def _multipart_bodies(content_type: str, body: bytes) -> list[bytes]:
    """The parts of a multipart/related STOW-RS body."""
    boundary = content_type.split("boundary=")[1].strip().encode()
    parts = body.split(b"--" + boundary)
    assert parts[0] == b"" and parts[-1] == b"--\r\n", "malformed multipart body"
    out = []
    for part in parts[1:-1]:
        head, payload = part.split(b"\r\n\r\n", 1)
        assert b"Content-Type: application/dicom" in head and payload.endswith(b"\r\n")
        out.append(payload[:-2])
    return out


def phase_pacs(torch, rc, pc) -> dict:
    """The PACS front door as a hospital deploys it: Orthanc's
    STABLE_SERIES callback (`pacs/on_change.py`) -> `analyze_stable_series
    .delay` -> the local queue's thread -> the worker (`pacs/worker.py`:
    download over Orthanc's REST API, `analyze_ct` on the card with
    `PACS_MODEL=total`, `FAST_TOTAL=1` and no `DEVICE`) -> the sinks
    (DICOM-SEG over STOW-RS, the workbook, preview and debug file to an SMB
    share, the monitoring rows to Postgres) -> the series deleted. Orthanc's
    REST API and the STOW-RS receiver are stdlib HTTP servers on localhost;
    `orthanc`, `smbclient` and `psycopg2` are stand-in modules (the card
    machine has none of them), `/storage_directory` does not exist, so the
    results leave the worker only through its sinks. Three stable series:
    (A) the bench's 512x512x300 CT as an uncompressed series (dicom (c)'s,
    or written here) on the full-width total_fast store: the SEG received
    over STOW-RS, read back, agrees > 0.99 with dicom (c)'s total.nii.gz
    (or with `cli.run` on the same series when the dicom phase did not run),
    the share holds the workbook (its info sheet with the series' DICOM
    rows), preview_total.png and debug_information.txt (naming the card)
    under the naming scheme's path, the last row computed with its times;
    (B) five instances: rejected by the gate and deleted, its row `none-<max
    id>`, not computed; (C) 20 instances with their pixel data cut short:
    "BOA analysis failed" in the debug file, the only file on the share, not
    computed. Every column written is one of deploy/init.sql's, Orthanc got
    DELETE for all three, and the launches are (A)'s tiles x (4, 1, 1) with
    no K5 and no finishing pass. The queue logs a task's exception and does
    not raise it, so every check reads the sinks and the rows."""
    import re as _re
    from pathlib import Path

    from boa_tpu_torch import cli
    from boa_tpu_torch.io import dicom, dicom_io, dicom_seg, nifti, storage
    from boa_tpu_torch.io.xlsx import read_xlsx
    from boa_tpu_torch.pacs import util as pacs_util
    from boa_tpu_torch.pacs import worker as pacs_worker
    from boa_tpu_torch.tasks.class_maps import get_class_map

    repo = Path(__file__).resolve().parent
    card = torch.cuda.get_device_name(0)
    res = {}
    t_phase = time.perf_counter()
    if Path("/storage_directory").exists():
        raise AssertionError("/storage_directory exists: the worker would keep its results")
    if _BCA_STUDY:   # bca (c)'s store, with dicom (c)'s series when that phase ran
        root, img = _BCA_STUDY["root"], _BCA_STUDY["img"]
    else:
        root, img = Path(_total_fast_store().root), _bench_ct(STUDY_SHAPE, (1.5, 1.5, 3.0))
    tmp_dir = tempfile.TemporaryDirectory()
    tmp = Path(tmp_dir.name)

    # --- the three series and the reference labels
    t0 = time.perf_counter()
    series_a = root / "series"
    res["series_a_from"] = "dicom (c)" if series_a.exists() else "written here"
    if not series_a.exists():
        series_a = tmp / "series"
        dicom_io.write_ct_series(img, series_a)
    small = _bench_ct((64, 64, 20), (1.5, 1.5, 3.0))
    series_c = tmp / "series_c"
    dicom_io.write_ct_series(small, series_c, accession="ACC16C", series_number=7,
                             series_description="CT cut short")
    res["series_write_s"] = time.perf_counter() - t0
    ref_path = root / "dicom" / "total.nii.gz"
    res["reference"] = "dicom (c)'s total.nii.gz"
    if not ref_path.exists():   # no dicom phase: the CLI on the same series
        env_before = dict(os.environ)
        os.environ.update(BOA_WEIGHTS_PATH=str(root))
        try:
            t0 = time.perf_counter()
            cli.run(["-i", str(series_a), "-o", str(tmp / "ref"), "-m", "total",
                     "--fast-total"])
            res["reference_s"] = time.perf_counter() - t0
        finally:
            os.environ.clear()
            os.environ.update(env_before)
        ref_path, res["reference"] = tmp / "ref" / "total.nii.gz", "cli.run on the series"

    def simplified_tags(path) -> dict:
        """Orthanc's simplified-tags of an instance."""
        ds = dicom.dcmread(path, stop_before_pixels=True)
        tags = {}
        for kw in ("PatientName", "PatientID", "StudyDate", "StudyDescription",
                   "AccessionNumber", "SeriesNumber", "SeriesDescription", "Modality",
                   "ImageType"):
            v = ds.get(kw)
            if v is not None:
                tags[kw] = [str(x) for x in v] if isinstance(v, (list, tuple)) else str(v)
        return tags

    files_a, files_c = sorted(series_a.iterdir()), sorted(series_c.iterdir())
    tags_a, tags_c = simplified_tags(files_a[0]), simplified_tags(files_c[0])
    state = {"deleted": [], "stow": [], "sql": [], "rollbacks": 0, "series": {
        "A": (tags_a, {f"a{k}": p for k, p in enumerate(files_a)}),
        "B": (tags_a, {f"b{k}": p for k, p in enumerate(files_a[:5])}),
        "C": (tags_c, {f"c{k}": p.read_bytes()[:-4096] for k, p in enumerate(files_c)})}}
    share = tmp / "share"
    orthanc_srv, stow_srv, stand_ins = _pacs_fakes(state, share)

    # --- the deployment's environment, stand-ins and queue files
    env_before = dict(os.environ)
    for var in ("DEVICE", "NVIDIA_ID", "CELERY_BROKER", "DELETE_SERIES_FROM_ORTHANC",
                "PATIENT_INFO_IN_OUTPUT", "FAST_BCA", "LICENSE_NUMBER"):
        os.environ.pop(var, None)
    os.environ.update(
        ORTHANC_URL="http://127.0.0.1", ORTHANC_PORT=str(orthanc_srv.server_port),
        ORTHANC_USERNAME="boa", ORTHANC_PASSWORD="boa-pw", PACS_MODEL="total",
        FAST_TOTAL="1", BOA_WEIGHTS_PATH=str(root),
        SEGMENTATION_UPLOAD_URL=f"http://127.0.0.1:{stow_srv.server_port}/dicom-web",
        UPLOAD_USER="stow", UPLOAD_PWD="stow-pw", SMB_DIR_OUTPUT="\\\\pacs-share\\boa",
        SMB_USER="smb", SMB_PWD="smb-pw", POSTGRES_HOST="monitoring",
        POSTGRES_PORT="5432", POSTGRES_USER="boa_user", POSTGRES_PASSWORD="pg-pw",
        POSTGRES_DATABASE="boa_tpu")
    saved_modules = {k: sys.modules.get(k) for k in (*stand_ins, "boa_tpu_torch.pacs.on_change")}
    sys.modules.update(stand_ins)
    sys.modules.pop("boa_tpu_torch.pacs.on_change", None)
    saved_files = pacs_worker.HEARTBEAT_FILE, pacs_worker.READINESS_FILE
    pacs_worker.HEARTBEAT_FILE, pacs_worker.READINESS_FILE = tmp / "heartbeat", tmp / "ready"
    sinks = {"seg_s": [], "stow_s": [], "stow_bytes": []}
    build, stow = storage.build_output_dicoms, storage.stow_rs

    def build_timed(*a, **kw):
        t0 = time.perf_counter()
        out = build(*a, **kw)
        sinks["seg_s"].append(time.perf_counter() - t0)
        return out

    def stow_timed(url, datasets, auth=None):
        t0 = time.perf_counter()
        stow(url, datasets, auth)
        sinks["stow_s"].append(time.perf_counter() - t0)

    storage.build_output_dicoms, storage.stow_rs = build_timed, stow_timed
    try:
        import boa_tpu_torch.pacs.on_change  # noqa: F401  (Orthanc loads the script)

        (callback,) = stand_ins["orthanc"].callbacks
        rc.reset_launches()
        pc.reset_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for series_id in ("A", "B", "C"):
            callback(stand_ins["orthanc"].ChangeType.STABLE_SERIES, 0, series_id)
        res["enqueue_s"] = time.perf_counter() - t0
        pacs_worker._local_queue.join()
        torch.cuda.synchronize()
        res["drive_s"] = time.perf_counter() - t0
        got = dict(rc.LAUNCHES, **pc.LAUNCHES)
        res["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        pacs_worker._local_queue.stop()
    finally:
        storage.build_output_dicoms, storage.stow_rs = build, stow
        pacs_worker.HEARTBEAT_FILE, pacs_worker.READINESS_FILE = saved_files
        for k, v in saved_modules.items():
            if v is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = v
        os.environ.clear()
        os.environ.update(env_before)
        orthanc_srv.shutdown()
        stow_srv.shutdown()

    # --- the sinks: rows, share, STOW-RS, Orthanc
    rows = _pacs_rows(state["sql"])
    enqueued = dict((s, t) for t, s in _re.findall(r"Enqueued task (\S+) for series (\S+)\.",
                                                   "\n".join(stand_ins["orthanc"].logs)))
    by_task = {}
    for row in rows:
        by_task.setdefault(row["task_id"], []).append(row)
    final_a, final_c = by_task[enqueued["A"]][-1], by_task[enqueued["C"]][-1]
    (row_b,) = by_task[f"none-{PACS_MAX_ID}"]
    columns = _boa_entries_columns(repo)
    dir_a = share.joinpath("pacs-share", "boa", *pacs_util.get_naming_scheme(
        {**tags_a, "CalledAET": "BOA"}).strip("/").split("/"))
    dir_c = share.joinpath("pacs-share", "boa", *pacs_util.get_naming_scheme(
        {**tags_c, "CalledAET": "BOA"}).strip("/").split("/"))
    shared = sorted(str(p.relative_to(share)) for p in share.rglob("*") if p.is_file())
    xlsx = pacs_util._process_info_element(
        tags_a, ["AccessionNumber", "SeriesNumber", "SeriesDescription"]) + ".xlsx"
    info = read_xlsx(dir_a / xlsx)["info"] if (dir_a / xlsx).exists() else []
    dicom_rows = {r["name"] for r in dicom_io.extract_metadata(
        dicom.dcmread(files_a[0], stop_before_pixels=True))}
    debug_a = (dir_a / "debug_information.txt").read_text()
    debug_c = (dir_c / "debug_information.txt").read_text()

    t0 = time.perf_counter()
    datasets = [dicom.dcmread(b) for _p, ct, body in state["stow"]
                for b in _multipart_bodies(ct, body)]
    segs = {ds.SeriesDescription: ds for ds in datasets}
    seg = segs["Total Body Segmentation"]
    vol, names = dicom_seg.read_seg_labelmap(seg)
    label_of = {name: lb for lb, name in get_class_map("total").items()}
    lut = np.zeros(max(names) + 1, np.int64)
    for segno, name in names.items():
        lut[segno] = label_of[name]
    labels = lut[vol]
    ref = np.asarray(nifti.load(ref_path).data)
    res["readback_s"] = time.perf_counter() - t0
    expect = _bca_tiles(img, (128, 128, 128), (3.0, 3.0, 3.0))["total"]
    res.update({
        "card": card, "rows": {s: by_task[t] for s, t in enqueued.items()},
        "row_b": row_b, "columns_outside_init_sql": sorted(set().union(*rows) - columns),
        "deleted": state["deleted"], "share": shared,
        "seg_s": sinks["seg_s"], "stow_s": sinks["stow_s"],
        "stow_posts": [(p, len(body)) for p, _ct, body in state["stow"]],
        "stow_datasets": sorted(segs), "seg_frames": int(seg.NumberOfFrames),
        "seg_segments": len(names), "agree": float((labels == ref).mean()) if
        labels.shape == ref.shape else 0.0, "labels_shape": list(labels.shape),
        "launches": got, "expected_tiles": expect,
        "phase_s": time.perf_counter() - t_phase})
    emit({"phase": "pacs", **res})
    assert final_a["computed"] is True, final_a
    assert {"download_time", "inference_time", "total_time",
            "save_persistent_time"} <= set(final_a), final_a
    assert final_c["computed"] is False and row_b["computed"] is False, (final_c, row_b)
    assert not res["columns_outside_init_sql"], res["columns_outside_init_sql"]
    assert sorted(state["deleted"]) == ["/series/A", "/series/B", "/series/C"], state["deleted"]
    for name in (xlsx, "preview_total.png", "debug_information.txt"):
        assert (dir_a / name).exists(), (name, shared)
    assert [p for p in shared if p.startswith(str(dir_c.relative_to(share)))] == \
        [str((dir_c / "debug_information.txt").relative_to(share))], shared
    assert "BOA analysis failed" in debug_c and "BOA analysis failed" not in debug_a
    assert card in debug_a, debug_a[:400]
    assert dicom_rows <= {r[0] for r in info if r}, (dicom_rows, info)
    assert len(state["stow"]) == 1 and state["stow"][0][0] == "/dicom-web/studies"
    assert res["agree"] > 0.99, res["agree"]
    assert got == _want_launches(expect), (got, expect)
    assert state["rollbacks"] == 0
    tmp_dir.cleanup()
    return res


def _row(name: str, mine: list[dict], checked: list[dict], launches: int) -> dict:
    """The kernel summary row: times and bounds summed over `mine`, the calls
    of one tile's forward; the largest error over every `checked` call."""
    per = [(max(c["bytes_ms"], c["ops_ms"]), c["ops_ms"] >= c["bytes_ms"]) for c in mine]
    bound_ms = sum(b for b, _ in per)
    ops_part = sum(b for b, by_ops in per if by_ops)
    return {"name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches,
            "max_abs_err": max(c["max_abs_err"] for c in checked),
            "ms": sum(c["kernel_ms"] for c in mine),
            "wrapper_ms": sum(c["wrapper_ms"] for c in mine),
            "plain_ms": sum(c["plain_ms"] for c in mine),
            "bound_ms": bound_ms,
            "bound_by": "operations" if 2 * ops_part >= bound_ms else "bytes",
            "library_ms": sum(c["library_ms"] for c in mine)}


def _summary(cases, fused_cases, fused, study, total, bca, cli, api, engine, tools,
             serve, pacs) -> list[dict]:
    summary = []
    for name in REPLACES:
        if name == "conv3d_in_act":  # per fused forward: its 17 calls
            summary.append(dict(_row(name, fused_cases, fused_cases, fused["launches"]),
                                finish_launches=fused["finish_launches"],
                                launches_cli=cli["study"]["launches"][name],
                                launches_api=api["nifti"]["launches"][name],
                                launches_engine=engine["pth"]["launches"][name],
                                launches_tools=tools["launches"][name],
                                launches_serve=serve["stream"]["launches"][name],
                                launches_pacs=pacs["launches"][name]))
            continue
        # per tile: the four conv3d_rows calls are 1->32, 32->32 (into the
        # concat), 64->32, 32->32; K2 and K3 on the concat slice, as the main
        # path runs them
        mine = [c for c in cases if c["name"] == name and c["n"] == 1
                and c["layout"] != "channels"]
        if name != "conv3d_rows":
            mine = [c for c in mine if c["layout"] == "concat"]
        row = _row(name, mine, [c for c in cases if c["name"] == name],
                   study["launches"][name])
        # the same kernels' launches on the full (five-model) total study and
        # on the BCA study (total fast and two 5-fold models)
        row["launches_total"] = total["study"]["launches"][name]
        row["launches_bca"] = bca["study"]["launches"][name]
        row["launches_cli"] = cli["study"]["launches"][name]
        row["launches_api"] = api["nifti"]["launches"][name]
        # engine (a): 8 forwards of a batch of 8 flips (64 network evaluations)
        row["launches_engine"] = engine["pth"]["launches"][name]
        # the tools' commands (b) on K1-K3, and the stream of serve (a)
        row["launches_tools"] = tools["launches"][name]
        row["launches_serve"] = serve["stream"]["launches"][name]
        # the PACS worker's series (A), from the Orthanc callback to the sinks
        row["launches_pacs"] = pacs["launches"][name]
        if name == "conv3d_rows":
            row["finish_launches"] = study["launches"]["conv3d_rows_finish"]
        summary.append(row)
    return summary


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from boa_tpu_torch import _build
    from boa_tpu_torch.device import resolve_device
    from boa_tpu_torch.ops import pallas_conv as pc
    from boa_tpu_torch.ops import rowconv as rc

    resolve_device("cuda")  # pins the float32 precision flags
    # predict_image counts predictions in the install config: keep this
    # run's counts in a folder of its own
    config_dir = tempfile.TemporaryDirectory()
    os.environ.setdefault("BOA_TPU_CONFIG_DIR", config_dir.name)
    profile_run = "--profile" in sys.argv[1:]
    phases = ALL_PHASES
    for arg in sys.argv[1:]:
        if arg.startswith("--phases="):
            phases = tuple(arg.split("=", 1)[1].split(","))
    unknown = set(phases) - set(ALL_PHASES)
    if unknown:
        print(f"chip_smoke: unknown phases {sorted(unknown)}", file=sys.stderr)
        return 2
    phase_device(torch, _build)
    if "kernels" in phases:
        cases = phase_kernels(torch, rc)
    if "forward" in phases:
        phase_forward(torch, rc)
    if "fused" in phases:
        fused_cases, fused = phase_fused(torch, rc, pc, profile_run)
    if "study" in phases:
        study = phase_study(torch, rc, pc, profile_run)
    if "total" in phases:
        total = phase_total(torch, rc, pc, profile_run)
    if "measure" in phases:
        phase_measure(torch, rc, pc, profile_run)
    if "bca" in phases:
        # with the cli phase after it, bca (c) only warms up: the cli phase
        # times the same study through the CLI
        bca = phase_bca(torch, rc, pc, timed="cli" not in phases)
    if "cli" in phases:
        cli = phase_cli(torch, rc, pc)
    if "dicom" in phases:
        phase_dicom(torch, rc, pc)
    if "render" in phases:
        phase_render(torch, rc, pc)
    if "api" in phases:
        api = phase_api(torch, rc, pc)
    if "engine" in phases:
        engine = phase_engine(torch, rc, pc)
    if "tools" in phases:
        tools = phase_tools(torch, rc, pc)
    if "serve" in phases:
        serve = phase_serve(torch, rc, pc)
    if "pacs" in phases:
        pacs = phase_pacs(torch, rc, pc)
    if phases == ALL_PHASES:
        emit({"kernels": _summary(cases, fused_cases, fused, study, total, bca, cli, api,
                                  engine, tools, serve, pacs)})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
