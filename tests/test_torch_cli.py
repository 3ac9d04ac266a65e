"""The port's front door against the reference's, on the CPU:
`commands.py:analyze_ct` (the golden workbook, and every sheet of a
`total+bca` run with contrast through the anatomy phantom's hook), the
CLI (`python -m boa_tpu_torch` as a subprocess on a tiny synthetic model
and through the hook; in-process for the env mirrors and what raises), the
flag helpers of `utils/config.py`, the weight root of `ModelStore()` and
the prediction counter of `utils/persistent_config.py`.

Bars: tests/test_golden_regression.py's (rel 1e-3, abs 1e-6) for every
numeric cell, strings, bools and empty cells equal; the provenance row
`BOAGitHash` and the debug header's device row excepted.
"""

import json
import logging
import os
import subprocess
import sys
from contextlib import nullcontext
from pathlib import Path

import numpy as np
import pytest

from boa_tpu import cli as jcli
from boa_tpu.commands import analyze_ct as janalyze
from boa_tpu.io import xlsx as jx
from boa_tpu.testing import anatomy as janat
from boa_tpu.utils import config as jconfig
from boa_tpu.utils import persistent_config as jpc
from boa_tpu_torch import cli as tcli
from boa_tpu_torch import commands as tcmd
from boa_tpu_torch.io import nifti as tn
from boa_tpu_torch.testing import anatomy as tanat
from boa_tpu_torch.utils import config as tconfig
from boa_tpu_torch.utils import persistent_config as tpc
from boa_tpu_torch.weights.store import ModelStore, create_synthetic_model, weights_root

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _config_dir(tmp_path, monkeypatch):
    """Each test's own install config; the CLI's logging set-up undone."""
    monkeypatch.setenv("BOA_TPU_CONFIG_DIR", str(tmp_path / "cfg"))
    for var in ("DEVICE", "NVIDIA_ID", "BOA_CONTRAST_MODEL", "BOA_GIT_MODEL", "BOA_PROFILE"):
        monkeypatch.delenv(var, raising=False)
    root = logging.getLogger()
    levels = root.level, [(h, h.level) for h in root.handlers]
    yield
    root.setLevel(levels[0])
    for h, level in levels[1]:
        h.setLevel(level)


def _numeric(v):
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def _same_sheets(got, want, skip_rows=("BOAGitHash",)):
    assert list(got) == list(want)
    for name in want:
        g_rows = [r for r in got[name] if not (r and r[0] in skip_rows)]
        w_rows = [r for r in want[name] if not (r and r[0] in skip_rows)]
        assert len(g_rows) == len(w_rows), name
        for r, (g, w) in enumerate(zip(g_rows, w_rows)):
            assert len(g) == len(w), f"{name} row {r} width"
            for a, b in zip(g, w):
                if _numeric(a) and _numeric(b):
                    assert a == pytest.approx(b, rel=1e-3, abs=1e-6), f"{name} row {r}"
                else:
                    assert a == b, f"{name} row {r}: {a!r} != {b!r}"


def test_workbook_matches_golden(tmp_path):
    """tests/test_golden_regression.py's study and fake through the port's
    analyze_ct: its two sheets at that test's bars."""
    from tests.test_golden_regression import GOLDEN, _fake

    rng = np.random.default_rng(42)
    shape = (64, 64, 48)
    gx = np.linspace(-1, 1, shape[0], dtype=np.float32)[:, None]
    gy = np.linspace(-1, 1, shape[1], dtype=np.float32)[None, :]
    body = (gx ** 2 / 0.6 + gy ** 2 / 0.5) < 1.0
    vol = np.where(body, 40.0, -1000.0).astype(np.float32)[:, :, None] + \
        10 * rng.standard_normal(shape, dtype=np.float32)
    tn.save(tn.NiftiImage(data=vol.astype(np.int16), affine=np.diag([-1.5, -1.5, 3.0, 1.0])),
            tmp_path / "study.nii.gz")
    out = tmp_path / "out"
    excel_path, stats = tcmd.analyze_ct(
        input_folder=tmp_path / "study.nii.gz", processed_output_folder=out,
        excel_output_folder=out, models=["total"], bca_pdf=False, total_preview=False,
        compute_contrast_information=False, fast_total=True, cnr_adjustment=True,
        fake_predict=_fake, device="cpu")
    golden = json.loads(GOLDEN.read_text())
    sheets = jx.read_xlsx(excel_path)
    _same_sheets({k: sheets[k] for k in golden}, golden)
    assert {"inference_time", "totalsegmentator_metrics_time", "excel_time",
            "total_time"} <= set(stats)


def _phantom(root: Path) -> Path:
    """tests/test_cli_e2e.py's phantom CT file (RAS, as the hook paints)."""
    shape, spacing = (160, 160, 48), (2.5, 2.5, 6.0)
    tn.save(tn.NiftiImage(data=tanat.synth_ct(shape=shape, spacing=spacing),
                          affine=np.diag([*spacing, 1.0])), root / "study.nii.gz")
    return root / "study.nii.gz"


def test_analyze_ct_matches_reference(tmp_path, caplog):
    """`total+bca` with contrast and CNR adjustment through the anatomy
    phantom's hook in both packages: the same six sheets and stats keys, the
    debug file's header and the stage spans logged in it (INFO, as the CLI
    sets it)."""
    caplog.set_level(logging.INFO)
    study = _phantom(tmp_path)
    kw = dict(models=["total", "bca"], bca_pdf=False, total_preview=False,
              fast_total=True, cnr_adjustment=True)
    want_path, want_stats = janalyze(study, tmp_path / "ref", tmp_path / "ref",
                                     fake_predict=janat.fake_predict_factory(), **kw)
    spans: dict = {}
    got_path, got_stats = tcmd.analyze_ct(study, tmp_path / "got", tmp_path / "got",
                                          fake_predict=tanat.fake_predict_factory(),
                                          device="cpu", spans=spans, **kw)
    got, want = jx.read_xlsx(got_path), jx.read_xlsx(want_path)
    _same_sheets(got, want)
    info = {r[0]: r[1] for r in got["info"]}
    assert {"Noise", "CNRAorta", "MeanAxisL3_cm", "PredictedContrastPhase",
            "PredictedContrastInGIT", "PredictedContrastInGITNote"} <= set(info)
    assert len(got["cnr-adjusted"]) == 5 and len(got["bca-slice-measurements"]) == 49
    assert set(got_stats) == set(want_stats)
    for key in ("num_voxels", "num_slices", "num_slices_resampled", "bca_regions",
                "iv_contrast_phase", "boa_version"):
        assert got_stats[key] == want_stats[key], key
    assert got_stats["git_contrast"] == pytest.approx(want_stats["git_contrast"], rel=1e-6)
    assert {"predict", "builder", "save_wait"} <= set(spans)
    debug = (tmp_path / "got" / "debug_information.txt").read_text()
    ref_debug = (tmp_path / "ref" / "debug_information.txt").read_text()
    assert debug.startswith("Platform: ") and "\nDevice: cpu\n" in debug
    assert "Torch version: " in debug and "JAX backend" in ref_debug
    for label in ("All segmentation models took", "BCA metrics took", "Workbook write took",
                  "Complete CT analysis took"):
        assert label in debug and label in ref_debug, label
    assert sorted(p.name for p in (tmp_path / "got").iterdir()) == \
        sorted(p.name for p in (tmp_path / "ref").iterdir())


def test_analyze_ct_from_jpeg_ls_series_matches_reference(tmp_path, monkeypatch, caplog):
    """tests/test_dicom.py's DICOM-directory study as a JPEG-LS series,
    through both packages' analyze_ct with tests/test_golden_regression.py's
    fake predict, contrast on (BOA_CONTRAST_MODEL names a file that does not
    exist, so the vendored folds score): image.nii.gz bit-identical to the
    source, both packages' files byte-identical, the info sheet's rows
    equal (the DICOM and contrast rows among them), and the ingest span in
    the debug file."""
    from boa_tpu_torch.io import dicom as td
    from boa_tpu_torch.io import dicom_io as tio
    from tests.test_golden_regression import _fake

    caplog.set_level(logging.INFO)
    monkeypatch.setenv("BOA_CONTRAST_MODEL", str(tmp_path / "missing.pkl"))
    rng = np.random.default_rng(12)
    data = np.full((40, 40, 16), -1000, np.int16)
    data[8:32, 8:32, :] = 40 + rng.integers(-20, 20, (24, 24, 16)).astype(np.int16)
    affine = np.diag([-1.5, -1.5, 3.0, 1.0])
    tio.write_ct_series(tn.NiftiImage(data=data, affine=affine), tmp_path / "dicoms",
                        transfer_syntax=td.JPEG_LS_LOSSLESS, extra={"KVP": 120.0})
    kw = dict(models=["total"], bca_pdf=False, total_preview=False, fast_total=True,
              fake_predict=_fake)
    got_path, got_stats = tcmd.analyze_ct(tmp_path / "dicoms", tmp_path / "got",
                                          tmp_path / "got", device="cpu", **kw)
    want_path, want_stats = janalyze(tmp_path / "dicoms", tmp_path / "ref", tmp_path / "ref",
                                     **kw)
    img = tn.load(tmp_path / "got" / "image.nii.gz")
    np.testing.assert_array_equal(img.data, data)
    np.testing.assert_allclose(img.affine, affine, atol=1e-6)
    for name in ("image.nii.gz", "total.nii.gz"):
        assert (tmp_path / "got" / name).read_bytes() == (tmp_path / "ref" / name).read_bytes()
    got, want = jx.read_xlsx(got_path), jx.read_xlsx(want_path)
    _same_sheets(got, want)
    info = {r[0]: (r[1:] or [None])[0] for r in got["info"]}
    assert info["Modality"] == "CT" and info["KVP"] == 120.0
    assert [r for r in got["info"] if r[0] == "SeriesInstanceUID"] == \
        [r for r in want["info"] if r[0] == "SeriesInstanceUID"]
    assert {"PredictedContrastPhase", "PredictedContrastInGIT"} <= set(info)
    names = [r[0] for r in got["info"]]
    assert names[:3] == ["BOAVersion", "BOAGitHash", "StudyInstanceUID"]
    assert got_stats["iv_contrast_phase"] == want_stats["iv_contrast_phase"]
    debug = (tmp_path / "got" / "debug_information.txt").read_text()
    assert "Study ingest took" in debug


_LOADED = r"""
import sys
import numpy as np
from boa_tpu_torch.io import dicom_codecs as tc
img = np.arange(64 * 64, dtype=np.uint16).reshape(64, 64) % 4096
assert (tc.decode_rle(tc.encode_rle(img), 64, 64, 2) == img).all()
assert (tc.decode_jpeg_lossless(tc.encode_jpeg_lossless_sv1(img)) == img).all()
assert (tc.decode_jpeg_ls(tc.encode_jpeg_ls(img)) == img).all()
assert (tc.decode_jpeg2000(tc.encode_jpeg2000(img)) == img).all()
assert tc.decode_jpeg_dct(tc.encode_jpeg_dct(img, precision=12)).shape == img.shape
maps = [line.split()[-1] for line in open("/proc/self/maps") if line.rstrip().endswith(".so")]
print("\n".join(sorted(set(maps))))
print("MODULES", sorted(m for m in sys.modules if m.split(".")[0] == "boa_tpu"))
"""


def test_decoders_load_the_port_library_only(tmp_path):
    """Decoding every syntax loads the four libraries from
    build/boa_tpu_torch_native/, and no module or library of boa_tpu/."""
    proc = subprocess.run([sys.executable, "-c", _LOADED], cwd=ROOT, capture_output=True,
                          text=True, timeout=120, env=_env(tmp_path))
    assert proc.returncode == 0, proc.stderr[-3000:]
    libs = proc.stdout.split("MODULES")[0].split()
    ours = [p for p in libs if "/build/boa_tpu_torch_native/" in p]
    assert sorted(Path(p).name for p in ours) == [
        "libjpeg2000.so", "libjpegdct.so", "libjpegll.so", "libjpegls.so"]
    assert all(Path(p).parent.parent == ROOT / "build" / "boa_tpu_torch_native" for p in ours)
    assert not [p for p in libs if "/boa_tpu/" in p or "libboa_native" in p]
    assert proc.stdout.rstrip().endswith("MODULES []")


def _env(tmp_path, **extra):
    env = dict(os.environ)
    for var in ("DEVICE", "NVIDIA_ID", "BOA_TEST_ANATOMY", "BOA_PROFILE"):
        env.pop(var, None)
    env.update(BOA_TPU_CONFIG_DIR=str(tmp_path / "cfg"), CUDA_VISIBLE_DEVICES="", **extra)
    return env


def _cli(args, env):
    return subprocess.run([sys.executable, "-m", "boa_tpu_torch", *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)


def test_cli_subprocess_end_to_end(tmp_path):
    """tests/test_cli_e2e.py's first run on the port, `--device cpu`, with
    the skip-contrast and no-PDF env mirrors and `--use-study-prefix`: the
    files are renamed, the debug file starts with `Platform:`, the counter
    (read by the reference's reader) counts the one prediction. Without
    `--device` on a machine without CUDA the run stops before writing."""
    wroot = tmp_path / "weights"
    create_synthetic_model(wroot, 297, "fast", num_classes=5,
                           trainer="nnUNetTrainer_4000epochs_NoMirroring",
                           patch_size=(16, 16, 16), spacing=(3.0, 3.0, 3.0), features=(4, 8))
    data = np.full((40, 36, 32), -1000, np.int16)
    data[8:32, 8:28, :] = 40
    tn.save(tn.NiftiImage(data=data, affine=np.diag([-1.5, -1.5, 3.0, 1.0])),
            tmp_path / "study.nii.gz")
    out = tmp_path / "out"
    env = _env(tmp_path, BOA_WEIGHTS_PATH=str(wroot), SKIP_CONTRAST_INFORMATION="1",
               BCA_NO_PDF="1")
    args = ["-i", str(tmp_path / "study.nii.gz"), "-o", str(out), "-m", "total",
            "--fast-total", "--verbose"]
    proc = _cli([*args, "--device", "cpu", "--use-study-prefix"], env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert sorted(p.name for p in out.iterdir()) == [
        "study_ct_pfav.nii.gz", "study_debug_information.txt", "study_output.xlsx",
        "study_total-measurements.json", "study_total-statistics.json",
        "study_total.nii.gz"]
    assert (out / "study_debug_information.txt").read_text().startswith("Platform: ")
    assert tn.load(out / "study_total.nii.gz").shape == (40, 36, 32)
    info = [r[0] for r in jx.read_xlsx(out / "study_output.xlsx")["info"]]
    assert not any(name.startswith("PredictedContrast") for name in info)
    assert jpc.get_config_key("prediction_counter") == 1

    proc = _cli([*args, "-o", str(tmp_path / "out2")], env)
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
    assert not (tmp_path / "out2").exists()


def test_cli_anatomy_hook_cnr_golden(tmp_path):
    """tests/test_cli_e2e.py's second run on the port: BCA, CNR adjustment
    and the dark theme through the BOA_TEST_ANATOMY hook (without the PDF):
    the BCA files, and the cnr-adjusted sheet against
    tests/data/golden_cnr_adjusted.csv at that test's rtol 0.12."""
    import csv

    study = _phantom(tmp_path)
    out = tmp_path / "out"
    proc = _cli(["-i", str(study), "-o", str(out), "-m", "total+bca", "--fast-total",
                 "--fast-bca", "--cnr-adjustment", "--theme", "dark", "--bca-no-pdf",
                 "--device", "cpu"],
                _env(tmp_path, SKIP_CONTRAST_INFORMATION="1", BOA_TEST_ANATOMY="1"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    for name in ("output.xlsx", "body_regions.nii.gz", "tissues.nii.gz",
                 "bca-measurements.json"):
        assert (out / name).exists(), name
    from boa_tpu_torch.io.xlsx import read_xlsx_sheet_table

    columns, rows = read_xlsx_sheet_table(out / "output.xlsx", "cnr-adjusted", header_row=1)
    with open(ROOT / "tests" / "data" / "golden_cnr_adjusted.csv") as f:
        golden = list(csv.reader(f))
    assert columns == golden[0]
    assert [r[0] for r in rows] == [g[0] for g in golden[1:]]
    for row, want in zip(rows, golden[1:]):
        for got, w in zip(row[1:], want[1:]):
            if w in ("True", "False"):
                assert got is (w == "True")
            elif w == "":
                assert got is None
            else:
                assert float(got) == pytest.approx(float(w), rel=0.12)


@pytest.mark.parametrize("flags,env,match", [
    # --radiomics raised here until it was ported (M9 (iii)), a trained
    # contrast bundle until M9 (vi): both now reach the models; the id keeps
    # the name this case had
    pytest.param(["-m", "bca", "--bca-no-pdf"], {"BOA_CONTRAST_MODEL": "bundle.pkl"},
                 "a model ran", id="flags1-env1-M9 \\(vi\\)"),
])
def test_unported_inputs_raise_before_any_model(tmp_path, monkeypatch, flags, env, match):
    """An input that raised NotImplementedError before any model until it
    was ported now goes on to the models: a trained contrast bundle that
    exists no longer refuses the study (tests/test_torch_contrast.py holds
    its rows against the reference's)."""
    def no_models(*a, **kw):
        raise AssertionError("a model ran")

    monkeypatch.setattr(tcmd, "compute_all_models", no_models)
    for k, v in env.items():
        (tmp_path / v).write_bytes(b"")
        monkeypatch.setenv(k, str(tmp_path / v))
    study = tmp_path / "ct.nii.gz"
    tn.save(tn.NiftiImage(data=np.zeros((8, 8, 8), np.int16), affine=np.eye(4)), study)
    with pytest.raises(AssertionError, match=match):
        tcli.run(["-i", str(study), "-o", str(tmp_path / "out"), "--device", "cpu", *flags])


@pytest.mark.parametrize("flags,render", [
    (["-m", "total", "--preview"], "preview_total.png"),
    (["-m", "total+bca"], "report.pdf"),
])
def test_renderer_flags_write_their_files(tmp_path, monkeypatch, flags, render):
    """`--preview`, and `bca` without `--bca-no-pdf`, which raised before any
    model until the renderers were ported (ROADMAP M9 (i)), run through the
    BOA_TEST_ANATOMY hook on the CPU and write their file with the rest."""
    monkeypatch.setenv("BOA_TEST_ANATOMY", "1")
    monkeypatch.setenv("SKIP_CONTRAST_INFORMATION", "1")
    study = _phantom(tmp_path)
    out = tmp_path / "out"
    tcli.run(["-i", str(study), "-o", str(out), "--fast-total", "--device", "cpu", *flags])
    files = {p.name for p in out.iterdir()}
    assert {render, "output.xlsx", "total.nii.gz"} <= files
    assert ("report.pdf" in files) == ("total+bca" in flags)
    assert ("preview_total.png" in files) == ("--preview" in flags)
    assert (out / render).stat().st_size > 1000


@pytest.mark.parametrize("worker", [False, True])
def test_analyze_ct_writes_the_renders(tmp_path, worker):
    """tests/test_commands.py's artefact check on the port: `total+bca` with
    `total_preview=True, bca_pdf=True` through the anatomy hook writes
    preview_total.png and report.pdf, with its own HostWorker and with a
    shared one (reaped by the caller)."""
    from boa_tpu_torch.utils.stages import HostWorker

    study = _phantom(tmp_path)
    out = tmp_path / "out"
    kw = dict(models=["total", "bca"], compute_contrast_information=True, total_preview=True,
              bca_pdf=True, fast_total=True, fake_predict=tanat.fake_predict_factory(),
              device="cpu")
    with HostWorker() as w:
        tcmd.analyze_ct(study, out, out, worker=w if worker else None, **kw)
    for art in ("preview_total.png", "report.pdf"):
        assert (out / art).stat().st_size > 1000, art


def test_empty_dicom_directory_raises_as_reference(tmp_path, monkeypatch):
    """A directory without a series raises the reference's ValueError from
    the ingest stage, inside the debug-file block: the debug file records
    the abort, and no model runs."""
    def no_models(*a, **kw):
        raise AssertionError("a model ran")

    monkeypatch.setattr(tcmd, "compute_all_models", no_models)
    (tmp_path / "dicoms").mkdir()
    with pytest.raises(ValueError, match="No DICOM series found") as got:
        tcli.run(["-i", str(tmp_path / "dicoms"), "-o", str(tmp_path / "out"), "--device",
                  "cpu", "--bca-no-pdf"])
    with pytest.raises(ValueError) as want:
        janalyze(tmp_path / "dicoms", tmp_path / "ref", tmp_path / "ref", ["total"],
                 bca_pdf=False, total_preview=False)
    assert str(got.value) == str(want.value)
    debug = (tmp_path / "out" / "debug_information.txt").read_text()
    assert debug.startswith("Platform: ") and "analyze_ct aborted with ValueError" in debug


def _captured(module, monkeypatch, argv):
    """The keyword arguments a CLI passes to its analyze_ct."""
    seen = {}
    monkeypatch.setattr(module, "analyze_ct", lambda **kw: seen.update(kw))
    (tcli if module is tcmd else jcli).run(argv)
    return seen


@pytest.mark.parametrize("env", [
    {},
    {"DEVICE": "cpu", "THEME": "dark", "LICENSE_NUMBER": "aca_0123456789ABCD",
     "FAST_BCA": "1", "FAST_TOTAL": "true", "BCA_NO_PDF": "1",
     "SKIP_CONTRAST_INFORMATION": "TRUE", "VERBOSE": "1"},
    {"PREDICT_FAST": "1", "LICENSE_NUMBER": "TODO", "FAST_BCA": "0"},
])
def test_env_mirrors_match_reference(tmp_path, monkeypatch, env):
    """Both CLIs give analyze_ct the same arguments under the env mirrors,
    the device spelled for each backend."""
    import boa_tpu.commands as jcmd

    for k, v in env.items():
        monkeypatch.setenv(k, v)
    argv = ["-i", str(tmp_path / "ct.nii.gz"), "-o", str(tmp_path), "-m", "total+liver-vessels"]
    with pytest.warns(DeprecationWarning) if "PREDICT_FAST" in env else nullcontext():
        got = _captured(tcmd, monkeypatch, argv)
    with pytest.warns(DeprecationWarning) if "PREDICT_FAST" in env else nullcontext():
        want = _captured(jcmd, monkeypatch, argv)
    assert got.pop("device") == want.pop("device").replace("tpu", "cuda")
    assert got == want
    assert got["fast_total"] == ("FAST_TOTAL" in env or "PREDICT_FAST" in env)


def test_device_and_help():
    assert "cuda, cuda:N or cpu" in tcli.get_parser().format_help()


@pytest.mark.parametrize("spec,env,want", [
    (None, {}, "cuda"), ("gpu", {}, "cuda"), ("TPU", {}, "cuda"), ("cuda:1", {}, "cuda:1"),
    ("cuda", {"NVIDIA_ID": "2"}, "cuda:2"), (None, {"DEVICE": "cpu"}, "cpu"),
    ("cpu", {}, "cpu"), (None, {"DEVICE": "gpu:3"}, "cuda:3"),
])
def test_resolve_device(monkeypatch, spec, env, want):
    """gpu, cuda and tpu mean the card; the reference's spelling is tpu."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert tconfig.resolve_device(spec) == want
    assert jconfig.resolve_device(spec).replace("tpu", "cuda") == want


def test_resolve_device_rejects_unknown():
    with pytest.raises(ValueError):
        tconfig.resolve_device("metal")


@pytest.mark.parametrize("spec", [None, "", "all", "ALL", "total", "total+bca",
                                  "body-parts+lung_vessels", "bca+body_regions",
                                  "total+nonsense", "heartchambers_highres"])
@pytest.mark.parametrize("license_number", [None, "aca_0123456789ABCD", "aca_short"])
def test_resolve_models_and_license_match_reference(spec, license_number):
    assert tconfig.resolve_models(spec, license_number=license_number) == \
        jconfig.resolve_models(spec, license_number=license_number)
    assert tconfig.is_valid_license(license_number) == jconfig.is_valid_license(license_number)
    if spec and "nonsense" in spec:
        with pytest.raises(ValueError):
            tconfig.resolve_models(spec, strict=True)


@pytest.mark.parametrize("value", [None, "", "1", "true", "True ", "0", "no", "TODO", "x"])
def test_env_helpers_match_reference(monkeypatch, value):
    if value is not None:
        monkeypatch.setenv("BOA_X", value)
    assert tconfig.env_bool("BOA_X", True) == jconfig.env_bool("BOA_X", True)
    assert tconfig.env_str("BOA_X", "d") == jconfig.env_str("BOA_X", "d")


def test_model_store_default_root(tmp_path, monkeypatch):
    """ModelStore() reads BOA_WEIGHTS_PATH, else ~/.boa_tpu/weights; a
    missing task names the env var."""
    monkeypatch.setenv("BOA_WEIGHTS_PATH", str(tmp_path / "w"))
    assert ModelStore().root == weights_root() == tmp_path / "w"
    with pytest.raises(FileNotFoundError, match="BOA_WEIGHTS_PATH"):
        ModelStore().model_dir(297)
    monkeypatch.delenv("BOA_WEIGHTS_PATH")
    monkeypatch.setenv("HOME", str(tmp_path))
    assert ModelStore().root == tmp_path / ".boa_tpu" / "weights"
    assert ModelStore(tmp_path / "x").root == tmp_path / "x"


def test_prediction_counter_shared_with_reference(tmp_path):
    """predict_image adds one per call; the file is the reference's layout,
    so that each package reads the other's."""
    from boa_tpu_torch.inference.pipeline import predict_image

    img = tn.NiftiImage(data=np.zeros((20, 20, 20), np.int16),
                        affine=np.diag([3.0, 3.0, 3.0, 1.0]))
    fake = lambda vol, spacing, tid: np.zeros(vol.shape, np.uint8)  # noqa: E731
    for _ in range(2):
        predict_image(img, "total", None, fast=True, fake_predict=fake, device="cpu")
    assert jpc.get_config_key("prediction_counter") == 2
    assert jpc.increase_prediction_counter() == 3
    assert tpc.increase_prediction_counter() == 4
    cfg = json.loads((tmp_path / "cfg" / "config.json").read_text())
    assert set(cfg) == {"boa_tpu_id", "prediction_counter", "license_number"}
    tpc.set_license_number("aca_0123456789ABCD")
    assert jpc.get_license_number() == "aca_0123456789ABCD"
    with pytest.raises(ValueError):
        tpc.set_license_number("nope")


def test_analyze_ct_defaults_to_cuda(tmp_path, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcmd.analyze_ct(tmp_path / "ct.nii.gz", tmp_path / "o", tmp_path / "o", ["total"],
                        total_preview=False)
    assert not (tmp_path / "o").exists()


def test_profile_writes_a_trace(tmp_path, monkeypatch):
    """BOA_PROFILE=<dir>: a torch.profiler trace of the study."""
    from tests.test_golden_regression import _fake

    tn.save(tn.NiftiImage(data=np.full((24, 24, 16), 40, np.int16),
                          affine=np.diag([1.5, 1.5, 3.0, 1.0])), tmp_path / "ct.nii.gz")
    monkeypatch.setenv("BOA_PROFILE", str(tmp_path / "prof"))
    tcmd.analyze_ct(tmp_path / "ct.nii.gz", tmp_path / "o", tmp_path / "o", ["total"],
                    total_preview=False, compute_contrast_information=False,
                    fast_total=True, fake_predict=_fake, device="cpu")
    assert json.loads((tmp_path / "prof" / "trace.json").read_text())["traceEvents"]
