"""The port's output sinks and SEG templates against the reference's, on the
CPU, and the port's deploy files.

- `io/storage.py:build_output_dicoms` as tests/test_dicom.py builds it (a
  `total` label file and a report.pdf beside a CT series): the same kinds
  and deterministic UIDs as the reference's, every element of every
  dataset equal with the clock frozen (the SEG writer's random
  DimensionOrganizationUID excepted), PixelData byte for byte;
- `stow_rs`'s multipart body parsed back into the same datasets;
- `templates/generate.py`: `template_for_kind` equal for all 12 kinds,
  `write_all` byte-identical to the committed metas of both packages, and
  tests/test_dicom.py's SNOMED checks on the port;
- the deploy files: `bash -n` on the entrypoint, the compose file parsed
  (the worker's command, the NVIDIA reservation, the devices), the
  dockerfiles copy `boa_tpu_torch` and not `boa_tpu`.
"""

import subprocess
import threading
from contextlib import contextmanager
from datetime import datetime
from http.server import BaseHTTPRequestHandler, HTTPServer
from pathlib import Path

import numpy as np
import pytest
import yaml

from boa_tpu.io import dicom as jd
from boa_tpu.io import dicom_io as jio
from boa_tpu.io import dicom_seg as jseg
from boa_tpu.io import nifti as jn
from boa_tpu.io import storage as jst
from boa_tpu.templates import generate as jgen
from boa_tpu_torch.io import dicom as td
from boa_tpu_torch.io import dicom_seg as tseg
from boa_tpu_torch.io import storage as tst
from boa_tpu_torch.templates import generate as tgen

ROOT = Path(__file__).resolve().parents[1]
DEPLOY = ROOT / "boa_tpu_torch" / "deploy"
FROZEN = datetime(2026, 1, 2, 3, 4, 5)
# drawn at random by both SEG writers
RANDOM_ELEMENTS = {"DimensionOrganizationUID"}


class _FrozenClock(datetime):
    @classmethod
    def now(cls, tz=None):
        return FROZEN


@pytest.fixture()
def frozen(monkeypatch):
    for mod in (jst, tst, jseg, tseg):
        monkeypatch.setattr(mod, "datetime", _FrozenClock)


def same_dataset(got, want, path=""):
    """Two datasets element for element (`RANDOM_ELEMENTS` excepted),
    sequences item by item, values of the same type."""
    keys = sorted(want.keys())
    assert sorted(got.keys()) == keys, path
    for tag in keys:
        kw = jd.TAG_TO_KEYWORD.get(tag, str(tag))
        if kw in RANDOM_ELEMENTS:
            continue
        g, w = got.get(tag), want.get(tag)
        if isinstance(w, list) and w and hasattr(w[0], "keys"):
            assert len(g) == len(w), f"{path}/{kw}"
            for i, (a, b) in enumerate(zip(g, w)):
                same_dataset(a, b, f"{path}/{kw}[{i}]")
        else:
            assert type(g) is type(w) and g == w, f"{path}/{kw}"


@pytest.fixture()
def study(tmp_path, rng):
    """tests/test_dicom.py's CT series, a `total` label file on its grid
    and a report.pdf."""
    data = rng.integers(-1000, 1500, size=(32, 28, 12)).astype(np.int16)
    affine = np.diag([-0.7, -0.7, 2.5, 1.0])
    affine[:3, 3] = (100.0, 80.0, -50.0)
    ct = jn.NiftiImage(data=data, affine=affine)
    jio.write_ct_series(ct, tmp_path / "dicoms", extra={"KVP": 120.0, "XRayTubeCurrent": 200})
    seg_dir = tmp_path / "segs"
    seg_dir.mkdir()
    seg = np.zeros(ct.shape, np.uint8)
    seg[5:15, 5:15, 3:9] = 1
    seg[20:26, 4:10, 6:11] = 3
    seg_img = jn.NiftiImage(data=seg, affine=affine.copy())
    seg_img.set_label_map({1: "spleen", 3: "liver"})
    jn.save(seg_img, seg_dir / "total.nii.gz")
    (seg_dir / "report.pdf").write_bytes(b"%PDF-1.4 x")
    return tmp_path / "dicoms", seg_dir


def test_build_output_dicoms_matches_reference(study, frozen):
    series, segs = study
    got, got_info = tst.build_output_dicoms(series, segs)
    want, want_info = jst.build_output_dicoms(series, segs)
    assert [i["name"] for i in got_info] == ["total", "report"]
    assert got_info == want_info   # the deterministic UIDs
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        same_dataset(g, w)
        same_dataset(g.file_meta, w.file_meta)
        assert td.dataset_bytes(g)[:128] == jd.dataset_bytes(w)[:128]
    assert got[0].get("PixelData") == want[0].get("PixelData")
    assert got[0].SeriesDescription == "Total Body Segmentation"
    assert got[0].SeriesDate == "20260102" and got[0].ContentTime == "030405"
    # the same inputs give the same UIDs
    again, again_info = tst.build_output_dicoms(series, segs)
    assert again_info == got_info
    labels, names = tseg.read_seg_labelmap(got[0])
    assert sorted(names.values()) == ["liver", "spleen"]


class StowHandler(BaseHTTPRequestHandler):
    """A DICOMweb STOW-RS receiver: keeps (path, headers, body) of each POST."""

    posts: list = []

    def log_message(self, *a):
        pass

    def do_POST(self):
        body = self.rfile.read(int(self.headers["Content-Length"]))
        type(self).posts.append((self.path, dict(self.headers), body))
        self.send_response(200)
        self.send_header("Content-Length", "0")
        self.end_headers()


@contextmanager
def serving(handler):
    """`handler` on a free localhost port, served on a thread; yields the port."""
    srv = HTTPServer(("127.0.0.1", 0), handler)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        yield srv.server_port
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(10)


def multipart_datasets(content_type: str, body: bytes) -> list:
    """The datasets of a multipart/related STOW-RS body, read by the port."""
    boundary = content_type.split("boundary=")[1].encode()
    parts = body.split(b"--" + boundary)
    assert parts[0] == b"" and parts[-1] == b"--\r\n"
    out = []
    for part in parts[1:-1]:
        head, payload = part.split(b"\r\n\r\n", 1)
        assert b"Content-Type: application/dicom" in head
        assert payload.endswith(b"\r\n")
        out.append(td.dcmread(payload[:-2]))
    return out


def test_store_dicoms_posts_stow_rs(study, frozen, monkeypatch):
    """`store_dicoms` in both packages against one STOW-RS server: the same
    path and auth, and bodies whose datasets are equal."""
    series, segs = study
    StowHandler.posts = []
    with serving(StowHandler) as port:
        monkeypatch.setenv("SEGMENTATION_UPLOAD_URL", f"http://127.0.0.1:{port}/")
        monkeypatch.setenv("UPLOAD_USER", "u")
        monkeypatch.setenv("UPLOAD_PWD", "p")
        got_info = tst.store_dicoms(series, segs)
        want_info = jst.store_dicoms(series, segs)
    assert got_info == want_info
    (gp, gh, gb), (wp, wh, wb) = StowHandler.posts
    assert gp == wp == "/studies"
    assert gh["Authorization"] == wh["Authorization"]
    assert gh["Accept"] == "application/dicom+json"
    got, want = multipart_datasets(gh["Content-Type"], gb), multipart_datasets(
        wh["Content-Type"], wb)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        same_dataset(g, w)


def test_store_dicoms_without_outputs_posts_nothing(tmp_path, study, monkeypatch):
    series, _ = study
    monkeypatch.delenv("SEGMENTATION_UPLOAD_URL", raising=False)
    (tmp_path / "empty").mkdir()
    assert tst.store_dicoms(series, tmp_path / "empty") == []


@pytest.mark.parametrize("kind", tst.SEG_OUTPUT_KINDS)
def test_template_for_kind_matches_reference(kind):
    assert tgen.template_for_kind(kind) == jgen.template_for_kind(kind)


def test_write_all_is_byte_identical(tmp_path):
    written = tgen.write_all(tmp_path)
    assert len(written) == len(tst.SEG_OUTPUT_KINDS) == 12
    for p in written:
        committed = ROOT / "boa_tpu_torch" / "templates" / p.name
        assert p.read_bytes() == committed.read_bytes(), p.name
        assert p.read_bytes() == (ROOT / "boa_tpu" / "templates" / p.name).read_bytes()
    assert (ROOT / "boa_tpu_torch/templates/snomed_mapping.csv").read_bytes() == \
        (ROOT / "boa_tpu/templates/snomed_mapping.csv").read_bytes()


def test_snomed_template_codes():
    """tests/test_dicom.py's SNOMED checks on the port's templates."""
    mapping = tgen.snomed_mapping()
    assert len(mapping) >= 117
    tpl = tgen.template_for_kind("total")
    segs = {s["SegmentLabel"]: s for s in tpl["segmentAttributes"][0]}
    liver = segs["liver"]["SegmentedPropertyTypeCodeSequence"]
    assert liver["CodeValue"] == mapping["liver"]["SegmentedPropertyTypeCodeSequence"][
        "CodeValue"]
    assert liver["CodeValue"] != "85756007"  # not the generic fallback
    left = segs["kidney_left"]
    assert left["SegmentedPropertyTypeModifierCodeSequence"]["CodeMeaning"] == "Left"
    assert all(s["SegmentedPropertyTypeCodeSequence"]["CodeValue"] != "85756007"
               for s in tpl["segmentAttributes"][0])


def test_label_maps_and_smb_path_match_reference(monkeypatch):
    for kind in [*tst.SEG_OUTPUT_KINDS, "unknown_kind"]:
        assert tst._label_map_for_kind(kind) == jst._label_map_for_kind(kind), kind
    for raw in ("\\\\server\\share\\dir", "//server/share/", "smb/share"):
        monkeypatch.setenv("SMB_DIR_OUTPUT", raw)
        assert tst._get_smb_info() == jst._get_smb_info()
    monkeypatch.setenv("SMB_DIR_OUTPUT", "server")
    for mod in (tst, jst):
        with pytest.raises(ValueError, match="UNC-style"):
            mod._get_smb_info()


# ------------------------------------------------------------ deploy files
def test_entrypoint_parses():
    sh = DEPLOY / "entrypoint.sh"
    r = subprocess.run(["bash", "-n", str(sh)], capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    text = sh.read_text()
    assert "python -m boa_tpu_torch.serve.warmup --bake" in text
    assert "boa_tpu.serve" not in text and 'gosu "$DOCKER_USER"' in text


def test_compose_runs_the_port_on_one_gpu():
    compose = yaml.safe_load((DEPLOY / "docker-compose.yml").read_text())
    services = compose["services"]
    gpu, cpu = services["worker-gpu"], services["worker-cpu"]
    for worker in (gpu, cpu):
        assert worker["command"].split()[:4] == ["celery", "-A", "boa_tpu_torch.pacs.worker",
                                                 "worker"]
        assert "--concurrency=1" in worker["command"]
        assert worker["build"]["dockerfile"] == "boa_tpu_torch/deploy/worker.dockerfile"
    assert gpu["environment"]["DEVICE"] == "cuda"
    assert cpu["environment"]["DEVICE"] == "cpu"
    assert "privileged" not in gpu
    devices = gpu["deploy"]["resources"]["reservations"]["devices"]
    assert devices == [{"driver": "nvidia", "count": 1, "capabilities": ["gpu"]}]
    assert services["orthanc"]["build"]["dockerfile"] == "boa_tpu_torch/deploy/orthanc.dockerfile"
    # the reused files exist at the paths the compose file names
    compose_dir = DEPLOY
    for svc in services.values():
        if "build" in svc:
            ctx = (compose_dir / svc["build"]["context"]).resolve()
            assert ctx == ROOT and (ctx / svc["build"]["dockerfile"]).exists()
    init_sql = services["monitoring"]["volumes"][0].split(":")[0]
    assert (compose_dir / init_sql).resolve() == ROOT / "deploy" / "init.sql"


@pytest.mark.parametrize("name", ["worker.dockerfile", "orthanc.dockerfile"])
def test_dockerfiles_copy_the_port(name):
    text = (DEPLOY / name).read_text()
    copies = [line.split()[1] for line in text.splitlines() if line.startswith("COPY ")]
    assert "boa_tpu_torch" in copies and "boa_tpu" not in copies
    for src in copies:
        assert (ROOT / src).exists(), src
    if name == "orthanc.dockerfile":
        assert "ORTHANC__PYTHON_SCRIPT=/python/boa_tpu_torch/pacs/on_change.py" in text
        assert "torch" not in text.split("pip install", 1)[1]
    else:
        assert "-devel" in text.splitlines()[[ln.startswith("FROM") for ln in
                                              text.splitlines()].index(True)]
