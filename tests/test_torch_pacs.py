"""The port's PACS layer (boa_tpu_torch/pacs/) against the reference's
(boa_tpu/pacs/), on the CPU, with the same fakes on both sides: a stdlib
HTTP server for Orthanc's REST API and one for DICOMweb STOW-RS, stand-in
`orthanc`, `smbclient`, `psycopg2` and `celery` modules.

A counterpart of each test of tests/test_pacs.py; the naming scheme equal
on arbitrary Unicode text (hypothesis); `collect_auth` on every form of
ORTHANC__REGISTERED_USERS; `upsert_sql`; both packages' worker on one
Orthanc through analyze_ct's `fake_predict`, held equal in its workbook,
output path, Postgres statements and values (times and timestamps
excepted), share contents and STOW-RS datasets (the clock frozen); the
failure path and the gate's rejection row; the Celery app's configuration;
the local queue from the callback; and that the callback's imports load
neither torch nor numpy. `DEVICE=cpu`: the tests ask for the CPU.
"""

import json
import subprocess
import sys
import threading
import types
from datetime import datetime
from http.server import BaseHTTPRequestHandler
from pathlib import Path

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from boa_tpu.io import dicom_io as jio
from boa_tpu.io import dicom_seg as jseg
from boa_tpu.io import nifti as jn
from boa_tpu.io import storage as jst
from boa_tpu.pacs import util as jutil
from boa_tpu.pacs import worker as jworker
from boa_tpu_torch.io import dicom_seg as tseg
from boa_tpu_torch.io import storage as tst
from boa_tpu_torch.io.xlsx import read_xlsx
from boa_tpu_torch.pacs import util as tutil
from boa_tpu_torch.pacs import worker as tworker
from tests.test_torch_storage import StowHandler, multipart_datasets, same_dataset, serving

ROOT = Path(__file__).resolve().parents[1]
PACKAGES = {"ref": (jutil, jworker), "port": (tutil, tworker)}
TAGS = {"StudyDate": "20260101", "AccessionNumber": "ACC1", "StudyDescription": "CT Thorax",
        "SeriesNumber": "3", "SeriesDescription": "axial", "Modality": "CT",
        "ImageType": ["ORIGINAL", "PRIMARY", "AXIAL"]}


# ------------------------------------------------------------ naming scheme
def test_replace_umlauts():
    for text, want in [("Müller-Lüdenscheidt", "Mueller-Luedenscheidt"),
                       ("Åse Øberg æther", "Aese Oeberg aether"),
                       ("Straße", "Strasse"), ("café naïve", "cafe naive")]:
        assert tutil._replace_umlauts(text) == want == jutil._replace_umlauts(text)


def test_process_info_element():
    tags = {"StudyDate": "20260101", "AccessionNumber": "A/B 1",
            "StudyDescription": "Thorax Röntgen"}
    keys = ["StudyDate", "AccessionNumber", "StudyDescription"]
    assert tutil._process_info_element(tags, keys) == "20260101_A_B_1_Thorax_Roentgen"
    assert tutil._process_info_element({}, ["SeriesNumber"]) == "UnknownSeriesNumber"
    assert tutil._process_info_element(tags, keys) == jutil._process_info_element(tags, keys)


def test_get_naming_scheme():
    tags = {"CalledAET": "BOA", "StudyDate": "20260101", "AccessionNumber": "ACC",
            "StudyDescription": "CT Abdomen", "SeriesNumber": "2",
            "SeriesDescription": "venös", "PatientName": "Müller",
            "PatientBirthDate": "19500101"}
    assert tutil.get_naming_scheme(tags) == "/BOA/20260101_ACC_CT_Abdomen/2_venoes/"
    assert tutil.get_naming_scheme(tags, patient_info=True) == \
        "/BOA/Mueller_19500101/20260101_ACC_CT_Abdomen/2_venoes/"


def test_naming_scheme_neutralizes_traversal():
    tags = {"CalledAET": "..", "StudyDate": "..", "AccessionNumber": "A1",
            "StudyDescription": "desc", "SeriesNumber": "2", "SeriesDescription": "ser"}
    path = tutil.get_naming_scheme(tags)
    assert ".." not in path.split("/") and path == jutil.get_naming_scheme(tags)
    tags["CalledAET"] = "BOA AET/evil"
    assert "/evil" not in tutil.get_naming_scheme(tags)[1:].split("/", 1)[0]


_TAG_NAMES = ["CalledAET", "StudyDate", "AccessionNumber", "StudyDescription",
              "SeriesNumber", "SeriesDescription", "PatientName", "PatientBirthDate"]


@settings(max_examples=60, deadline=None, database=None)
@given(values=st.dictionaries(st.sampled_from(_TAG_NAMES[1:]), st.text(max_size=12)),
       called=st.text(max_size=8), patient=st.booleans())
def test_naming_equal_on_any_text(values, called, patient):
    """Both packages give the same segment and path for any Unicode tag
    values, and no segment of the path is '..' or empty."""
    tags = {"CalledAET": called, **values}
    assert tutil._sanitize_segment(called) == jutil._sanitize_segment(called)
    for layer in (tutil._STUDY_LAYER, tutil._SERIES_LAYER, tutil._PATIENT_LAYER):
        assert tutil._process_info_element(tags, layer) == \
            jutil._process_info_element(tags, layer)
    path = tutil.get_naming_scheme(tags, patient)
    assert path == jutil.get_naming_scheme(tags, patient)
    segments = path[1:-1].split("/")
    assert len(segments) == 3 + patient
    assert all(s and s.strip(".") for s in segments), path


# ------------------------------------------------------------ auth and SQL
@pytest.mark.parametrize("env, want", [
    ({"ORTHANC_USERNAME": "u", "ORTHANC_PASSWORD": "p"}, ("u", "p")),
    ({"ORTHANC_USERNAME": "u", "ORTHANC_PASSWORD": "p",
      "ORTHANC__REGISTERED_USERS": '{"x": "y"}'}, ("u", "p")),
    ({"ORTHANC__REGISTERED_USERS": '{"alice": "s3cret"}'}, ("alice", "s3cret")),
    ({"ORTHANC__REGISTERED_USERS": "{'bob': 'pw'}"}, ("bob", "pw")),
    ({"ORTHANC__REGISTERED_USERS": '{"a": "1", "b": "2"}'}, ("a", "1")),
    ({"ORTHANC__REGISTERED_USERS": '{"it\'s": "pw", }'}, ("s", "pw")),
    ({"ORTHANC__REGISTERED_USERS": "{'carol': 'pw', }"}, ("carol", "pw")),
    ({"ORTHANC_USERNAME": "only-user", "ORTHANC__REGISTERED_USERS": '{"d": "e"}'},
     ("d", "e")),
    ({"ORTHANC__REGISTERED_USERS": "{}"}, ValueError),
    ({"ORTHANC__REGISTERED_USERS": "not a dict"}, ValueError),
    ({}, ValueError),
])
def test_collect_auth(monkeypatch, env, want):
    for var in ("ORTHANC_USERNAME", "ORTHANC_PASSWORD", "ORTHANC__REGISTERED_USERS"):
        monkeypatch.delenv(var, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    if want is ValueError:
        for util in (tutil, jutil):
            with pytest.raises(ValueError):
                util.collect_auth()
    else:
        assert tutil.collect_auth() == want == jutil.collect_auth()


def test_upsert_sql():
    q = tutil.upsert_sql(["task_id", "computed", "total_time"])
    assert "INSERT INTO boa_entries (task_id, computed, total_time)" in q
    assert "ON CONFLICT (task_id) DO UPDATE" in q
    assert "computed = EXCLUDED.computed" in q
    for keys in (["task_id"], ["task_id", "computed", "total_time"],
                 ["start_timestamp", "task_id", "accession_number"]):
        assert tutil.upsert_sql(keys) == jutil.upsert_sql(keys)
    for util in (tutil, jutil):
        with pytest.raises(ValueError):
            util.upsert_sql(["task_id", "bad-col; DROP"])


# ------------------------------------------------------------ stand-ins
class FakeDB:
    """A stand-in `psycopg2`: every connection records its statements."""

    def __init__(self, max_id=41):
        self.executed: list = []
        self.max_id = max_id

    def module(self):
        db = self

        class Cursor:
            def __enter__(self):
                return self

            def __exit__(self, *a):
                return False

            def execute(self, sql, values=None):
                db.executed.append((sql, values))

            def fetchone(self):
                return (db.max_id,)

        class Connection:
            def cursor(self):
                return Cursor()

            def commit(self):
                pass

            def rollback(self):
                pass

            def close(self):
                pass

        mod = types.ModuleType("psycopg2")
        mod.connect = lambda **kw: Connection()
        return mod

    def rows(self):
        """The upserted rows as dicts, in order."""
        out = []
        for sql, values in self.executed:
            if sql.startswith("INSERT"):
                cols = sql.split("(", 1)[1].split(")", 1)[0].split(", ")
                out.append(dict(zip(cols, values)))
        return out


def fake_smbclient(share: Path, current: dict):
    """A stand-in `smbclient` that copies into the local folder
    `share/<current["name"]>`: `//server/share/dir/` lands in
    `share/<name>/server/share/dir/`."""
    import shutil

    def local(path: str) -> Path:
        parts = [p for p in path.replace("\\", "/").split("/") if p]
        return share.joinpath(current["name"], *parts)

    mod = types.ModuleType("smbclient")
    mod.ClientConfig = lambda **kw: None
    mod.register_session = lambda server, **kw: None
    mod.delete_session = lambda server: None
    mod.makedirs = lambda path, exist_ok=False: local(path).mkdir(parents=True,
                                                                  exist_ok=exist_ok)
    sub = types.ModuleType("smbclient.shutil")
    sub.copy2 = lambda src, dst: shutil.copy2(src, local(dst))
    mod.shutil = sub
    return mod, sub


class OrthancHandler(BaseHTTPRequestHandler):
    """Orthanc's REST API over `series`: id -> (tags, {instance id: bytes})."""

    series: dict = {}
    deleted: list = []

    def log_message(self, *a):
        pass

    def _instance(self, inst):
        for tags, files in self.series.values():
            if inst in files:
                return tags, files[inst]
        raise KeyError(inst)

    def do_GET(self):
        parts = self.path.split("?")[0].split("/")
        if parts[1] == "series" and parts[2] in self.series:
            body = json.dumps({"Instances": list(self.series[parts[2]][1])}).encode()
        elif parts[1] == "instances" and parts[3] == "metadata":
            body = json.dumps({"CalledAET": "BOA"}).encode()
        elif parts[1] == "instances" and parts[3] == "simplified-tags":
            body = json.dumps(self._instance(parts[2])[0]).encode()
        elif parts[1] == "instances" and parts[3] == "file":
            body = self._instance(parts[2])[1]
        else:
            self.send_response(404)
            self.end_headers()
            return
        self.send_response(200)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_DELETE(self):
        type(self).deleted.append(self.path)
        self.send_response(200)
        self.send_header("Content-Length", "0")
        self.end_headers()


def series_files(folder: Path, n_slices: int, cut: int = 0) -> dict:
    """A CT series of `n_slices` (tests/test_pacs.py's volume), instance id ->
    file bytes; `cut` bytes taken off the end of every file."""
    data = np.full((24, 24, n_slices), -1000, np.int16)
    data[6:18, 6:18, :] = 50
    img = jn.NiftiImage(data=data, affine=np.diag([-1.5, -1.5, 3.0, 1.0]))
    files = jio.write_ct_series(img, folder)
    return {f"inst{k}": (p.read_bytes()[:-cut] if cut else p.read_bytes())
            for k, p in enumerate(sorted(files))}


class _FrozenClock(datetime):
    @classmethod
    def now(cls, tz=None):
        return datetime(2026, 1, 2, 3, 4, 5)


def fake_analyze(package):
    """analyze_fn for the worker: the package's own analyze_ct with
    tests/test_pacs.py's fake prediction, without the preview and contrast
    (`device` is build_excel's, from DEVICE)."""
    if package == "ref":
        from boa_tpu.commands import analyze_ct
    else:
        from boa_tpu_torch.commands import analyze_ct

    def fake(vol, spacing, task_id):
        seg = np.zeros(vol.shape, np.uint8)
        seg[8:16, 8:16, 2:10] = 1
        seg[4:8, 14:20, 3:6] = 5
        return seg

    def run(input_folder, processed_output_folder, excel_output_folder, models, **kw):
        assert list(models) == ["total"]
        assert kw["device"] == "cpu" and kw["fast_total"] is True
        return analyze_ct(input_folder=input_folder,
                          processed_output_folder=processed_output_folder,
                          excel_output_folder=excel_output_folder, models=models,
                          bca_pdf=False, compute_contrast_information=False,
                          total_preview=False, fast_total=True, fake_predict=fake,
                          **({"device": "cpu"} if package == "port" else {}))

    return run


@pytest.fixture()
def pacs_env(tmp_path, monkeypatch):
    """The deployment's environment around a fake Orthanc, a STOW-RS server,
    an SMB share and a monitoring DB, shared by both packages."""
    db = FakeDB()
    share, current = tmp_path / "share", {"name": "port"}
    smb, smb_shutil = fake_smbclient(share, current)
    monkeypatch.setitem(sys.modules, "psycopg2", db.module())
    monkeypatch.setitem(sys.modules, "smbclient", smb)
    monkeypatch.setitem(sys.modules, "smbclient.shutil", smb_shutil)
    for mod in (jst, tst, jseg, tseg):
        monkeypatch.setattr(mod, "datetime", _FrozenClock)
    for worker in (jworker, tworker):
        monkeypatch.setattr(worker, "HEARTBEAT_FILE", tmp_path / "heartbeat")
        monkeypatch.setattr(worker, "READINESS_FILE", tmp_path / "ready")
    OrthancHandler.series, OrthancHandler.deleted, StowHandler.posts = {}, [], []
    with serving(OrthancHandler) as orthanc_port, serving(StowHandler) as stow_port:
        env = {"ORTHANC_URL": "http://127.0.0.1", "ORTHANC_PORT": str(orthanc_port),
               "ORTHANC_USERNAME": "u", "ORTHANC_PASSWORD": "p", "PACS_MODEL": "total",
               "FAST_TOTAL": "1", "DEVICE": "cpu",
               "SEGMENTATION_UPLOAD_URL": f"http://127.0.0.1:{stow_port}",
               "UPLOAD_USER": "up", "UPLOAD_PWD": "pw",
               "SMB_DIR_OUTPUT": "\\\\smbserver\\results", "SMB_USER": "s",
               "SMB_PWD": "t", "POSTGRES_HOST": "db", "POSTGRES_PORT": "5432",
               "POSTGRES_USER": "boa", "POSTGRES_PASSWORD": "x",
               "POSTGRES_DATABASE": "boa_tpu", "BOA_TPU_CONFIG_DIR": str(tmp_path / "cfg")}
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        for var in ("CELERY_BROKER", "PATIENT_INFO_IN_OUTPUT", "FAST_BCA",
                    "DELETE_SERIES_FROM_ORTHANC", "LICENSE_NUMBER"):
            monkeypatch.delenv(var, raising=False)
        yield types.SimpleNamespace(db=db, share=share, current=current, tmp=tmp_path)


def _volatile(key: str) -> bool:
    return key.endswith("_time") or key.endswith("_timestamp")


def _share_files(share: Path) -> dict:
    return {str(p.relative_to(share)): p for p in sorted(share.rglob("*")) if p.is_file()}


def run_worker_both(pacs_env, series_id: str) -> dict:
    """Both packages' task body on one Orthanc series; per package: the
    result, the rows, the share's files, the STOW-RS datasets, the DELETEs."""
    out = {}
    for name, (_util, worker) in PACKAGES.items():
        pacs_env.db.executed.clear()
        StowHandler.posts.clear()
        OrthancHandler.deleted.clear()
        pacs_env.current["name"] = name
        res = worker.run_analyze_stable_series(
            series_id, **{"__task_id": f"task-{series_id}"}, analyze_fn=fake_analyze(name),
            storage_root=pacs_env.tmp / "no_storage_directory")
        share = pacs_env.share / name
        out[name] = {"res": res, "rows": pacs_env.db.rows(),
                     "files": _share_files(share) if share.exists() else {},
                     "stow": [multipart_datasets(h["Content-Type"], body)
                              for _p, h, body in StowHandler.posts],
                     "deleted": list(OrthancHandler.deleted)}
    return out


def _boa_columns() -> set:
    sql = (ROOT / "deploy" / "init.sql").read_text()
    body = sql.split("CREATE TABLE boa_entries (", 1)[1].split(");", 1)[0]
    return {line.split()[0] for line in body.strip().splitlines()
            if line.strip() and not line.strip().startswith("UNIQUE")}


def test_worker_matches_reference(pacs_env):
    """Series A through both workers: the same result, rows, share, STOW-RS
    datasets and DELETE."""
    OrthancHandler.series["series-A"] = (TAGS, series_files(pacs_env.tmp / "a", 12))
    out = run_worker_both(pacs_env, "series-A")
    got, want = out["port"], out["ref"]
    assert got["res"]["computed"] is True and want["res"]["computed"] is True
    assert Path(got["res"]["outputs"]).name == Path(want["res"]["outputs"]).name \
        == "ACC1_3_axial.xlsx"
    # Postgres: the start row, then the stats row; times and timestamps aside
    assert len(got["rows"]) == len(want["rows"]) == 2
    for g, w in zip(got["rows"], want["rows"]):
        assert list(g) == list(w)
        assert {k: v for k, v in g.items() if not _volatile(k)} == \
            {k: v for k, v in w.items() if not _volatile(k)}
    final = got["rows"][-1]
    assert final["computed"] is True and final["task_id"] == "task-series-A"
    assert {"download_time", "inference_time", "total_time", "save_persistent_time",
            "start_timestamp"} <= set(got["rows"][0]) | set(final)
    assert set().union(*got["rows"]) <= _boa_columns()
    assert [sql for sql, _ in pacs_env.db.executed] == \
        [tutil.upsert_sql(list(r)) for r in got["rows"]]
    # the share: the workbook, the debug file under the naming scheme's path
    prefix = "smbserver/results/BOA/20260101_ACC1_CT_Thorax/3_axial/"
    assert sorted(got["files"]) == sorted(want["files"]) == [
        prefix + "ACC1_3_axial.xlsx", prefix + "debug_information.txt"]
    g_book = read_xlsx(got["files"][prefix + "ACC1_3_axial.xlsx"])
    w_book = read_xlsx(want["files"][prefix + "ACC1_3_axial.xlsx"])
    assert list(g_book) == list(w_book)
    for sheet in w_book:
        g_rows = [r for r in g_book[sheet] if not (r and r[0] == "BOAGitHash")]
        w_rows = [r for r in w_book[sheet] if not (r and r[0] == "BOAGitHash")]
        assert len(g_rows) == len(w_rows), sheet
        for a, b in zip(g_rows, w_rows):
            assert a == pytest.approx(b, rel=1e-6), sheet
    info = {r[0]: r[1] for r in g_book["info"] if len(r) > 1}
    assert {"StudyInstanceUID", "SeriesInstanceUID", "Modality"} <= set(info)
    # STOW-RS: one POST each, the same SEG datasets
    assert len(got["stow"]) == len(want["stow"]) == 1
    assert len(got["stow"][0]) == len(want["stow"][0]) >= 1
    for g, w in zip(got["stow"][0], want["stow"][0]):
        same_dataset(g, w)
    assert got["stow"][0][0].SeriesDescription == "Total Body Segmentation"
    assert got["deleted"] == want["deleted"] == ["/series/series-A"]


def test_worker_failure_path_matches_reference(pacs_env):
    """Series C, pixel data cut short: the analysis fails in both, the row
    says so, only the debug file reaches the share, no STOW-RS post."""
    OrthancHandler.series["series-C"] = (TAGS, series_files(pacs_env.tmp / "c", 20, cut=300))
    out = run_worker_both(pacs_env, "series-C")
    for name, o in out.items():
        assert o["res"] == {"outputs": None, "computed": False}, name
        assert o["rows"][-1]["computed"] is False
        (path,) = o["files"]
        assert path.endswith("3_axial/debug_information.txt")
        assert "BOA analysis failed" in o["files"][path].read_text()
        assert o["stow"] == [] and o["deleted"] == ["/series/series-C"]
    assert [list(r) for r in out["port"]["rows"]] == [list(r) for r in out["ref"]["rows"]]


def test_worker_integration(tmp_path, monkeypatch):
    """tests/test_pacs.py's integration run on the port: a mounted storage
    directory, no sink configured."""
    OrthancHandler.series = {"series-1": ({k: TAGS[k] for k in (
        "StudyDate", "AccessionNumber", "StudyDescription", "SeriesNumber",
        "SeriesDescription")}, series_files(tmp_path / "dicoms", 12))}
    OrthancHandler.deleted = []
    for var in ("SEGMENTATION_UPLOAD_URL", "SMB_DIR_OUTPUT", "POSTGRES_HOST"):
        monkeypatch.delenv(var, raising=False)
    with serving(OrthancHandler) as port:
        for k, v in {"ORTHANC_URL": "http://127.0.0.1", "ORTHANC_PORT": str(port),
                     "ORTHANC_USERNAME": "u", "ORTHANC_PASSWORD": "p",
                     "PACS_MODEL": "total", "DEVICE": "cpu", "FAST_TOTAL": "1",
                     "BOA_TPU_CONFIG_DIR": str(tmp_path / "cfg")}.items():
            monkeypatch.setenv(k, v)
        storage = tmp_path / "storage"
        storage.mkdir()
        res = tworker.run_analyze_stable_series("series-1", analyze_fn=fake_analyze("port"),
                                                storage_root=storage)
    assert res["computed"] is True
    out = Path(res["outputs"])
    assert out.exists() and out.name == "ACC1_3_axial.xlsx"
    assert (out.parent / "total.nii.gz").exists()
    assert out.parent == storage / "BOA" / "20260101_ACC1_CT_Thorax" / "3_axial"
    assert OrthancHandler.deleted == ["/series/series-1"]


def test_worker_without_storage_or_sinks_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("ORTHANC_URL", "http://127.0.0.1")
    monkeypatch.setenv("ORTHANC_PORT", "1")
    monkeypatch.setenv("ORTHANC_USERNAME", "u")
    monkeypatch.setenv("ORTHANC_PASSWORD", "p")
    monkeypatch.setenv("SMB_DIR_OUTPUT", "\\\\s\\share")   # a lone variable is no sink
    for var in ("SMB_USER", "SMB_PWD", "SEGMENTATION_UPLOAD_URL"):
        monkeypatch.delenv(var, raising=False)
    for worker in (tworker, jworker):
        with pytest.raises(ValueError, match="will not be able to retrieve"):
            worker.run_analyze_stable_series("x", storage_root=tmp_path / "absent")


# ------------------------------------------------------------ Orthanc callback
@pytest.fixture()
def fake_orthanc(monkeypatch):
    """tests/test_pacs.py's stand-in `orthanc` module, its REST reads backed
    by OrthancHandler.series."""
    mod = types.ModuleType("orthanc")
    mod.logs, mod.deleted = [], []
    mod.LogWarning = mod.logs.append
    mod.RestApiDelete = mod.deleted.append
    mod.RegisterOnChangeCallback = lambda cb: None
    mod.ChangeType = types.SimpleNamespace(STABLE_SERIES=9)

    def rest_get(path):
        parts = path.split("/")
        if parts[1] == "series":
            return json.dumps({"Instances": list(OrthancHandler.series[parts[2]][1])})
        for tags, files in OrthancHandler.series.values():
            if parts[2] in files:
                return json.dumps(tags)
        raise KeyError(path)

    mod.RestApiGet = rest_get
    monkeypatch.setitem(sys.modules, "orthanc", mod)
    for name in ("boa_tpu.pacs.on_change", "boa_tpu_torch.pacs.on_change"):
        monkeypatch.delitem(sys.modules, name, raising=False)
    yield mod
    for name in ("boa_tpu.pacs.on_change", "boa_tpu_torch.pacs.on_change"):
        sys.modules.pop(name, None)


def _on_change_modules():
    import boa_tpu.pacs.on_change as joc
    import boa_tpu_torch.pacs.on_change as toc

    return {"ref": joc, "port": toc}


def test_gating(fake_orthanc):
    good = {"Modality": "CT", "ImageType": ["ORIGINAL", "AXIAL"]}
    cases = [({"Instances": list(range(20))}, good, True),
             ({"Instances": [1, 2]}, good, False),
             ({"Instances": list(range(20))}, {"Modality": "MR"}, False),
             ({"Instances": list(range(20))}, {"Modality": "CT", "ImageType": ["LOCALIZER"]},
              False),
             ({"Instances": list(range(20))}, {}, True)]   # missing tags pass
    for name, oc in _on_change_modules().items():
        for info, tags, want in cases:
            assert oc.generate_task(info, tags) is want, (name, info, tags)
            assert oc._gate_reason(info, tags, 10) == \
                _on_change_modules()["ref"]._gate_reason(info, tags, 10)
    assert len(fake_orthanc.logs) == 2 * 3


def test_on_change_enqueues(fake_orthanc, monkeypatch):
    oc = _on_change_modules()["port"]
    OrthancHandler.series = {
        "res-1": (TAGS, {f"i{k}": b"" for k in range(15)}),
        "res-2": (TAGS, {"j0": b""})}
    queued = []
    monkeypatch.setattr(oc.analyze_stable_series, "delay",
                        lambda resource_id: queued.append(resource_id) or
                        types.SimpleNamespace(id="t1"))
    monkeypatch.delenv("POSTGRES_HOST", raising=False)
    oc.on_change(fake_orthanc.ChangeType.STABLE_SERIES, 0, "res-1")
    oc.on_change(fake_orthanc.ChangeType.STABLE_SERIES + 1, 0, "res-1")   # not stable
    assert queued == ["res-1"] and fake_orthanc.deleted == []
    oc.on_change(fake_orthanc.ChangeType.STABLE_SERIES, 0, "res-2")
    assert fake_orthanc.deleted == ["/series/res-2"]


def test_gate_rejection_row_matches_reference(fake_orthanc, pacs_env, monkeypatch):
    """Series B, five instances: rejected and deleted in both packages, its
    row `none-<max id>` with computed False."""
    OrthancHandler.series = {"series-B": (TAGS, {f"b{k}": b"" for k in range(5)})}
    rows = {}
    for name, oc in _on_change_modules().items():
        pacs_env.db.executed.clear()
        fake_orthanc.deleted.clear()
        monkeypatch.setattr(oc.analyze_stable_series, "delay",
                            lambda resource_id: pytest.fail("a rejected series was queued"))
        oc.on_change(fake_orthanc.ChangeType.STABLE_SERIES, 0, "series-B")
        assert fake_orthanc.deleted == ["/series/series-B"]
        assert pacs_env.db.executed[0] == ("SELECT MAX(id) FROM boa_entries", None)
        rows[name] = pacs_env.db.rows()
    (got,), (want,) = rows["port"], rows["ref"]
    assert got["task_id"] == "none-41" and got["computed"] is False
    assert {k: v for k, v in got.items() if not _volatile(k)} == \
        {k: v for k, v in want.items() if not _volatile(k)}
    assert set(got) <= _boa_columns()


def test_local_queue_from_the_callback(fake_orthanc, pacs_env, monkeypatch):
    """The port's callback on a stable series -> `analyze_stable_series.delay`
    -> a LocalQueue thread -> the task body with the package's analyze_ct
    (the fake prediction patched into `commands.analyze_ct`), then the
    heartbeat and readiness files and the queue's stop."""
    from boa_tpu_torch import commands

    OrthancHandler.series["series-Q"] = (TAGS, series_files(pacs_env.tmp / "q", 12))
    analyze = fake_analyze("port")
    monkeypatch.setattr(commands, "analyze_ct", lambda **kw: analyze(**kw))
    queue = tworker.LocalQueue()
    monkeypatch.setattr(tworker, "_local_queue", queue)
    oc = _on_change_modules()["port"]
    oc.on_change(fake_orthanc.ChangeType.STABLE_SERIES, 0, "series-Q")
    waiter = threading.Thread(target=queue.join, daemon=True)
    waiter.start()
    waiter.join(60)
    assert not waiter.is_alive()
    assert (pacs_env.tmp / "ready").exists() and (pacs_env.tmp / "heartbeat").exists()
    rows = pacs_env.db.rows()
    task_id = rows[0]["task_id"]
    assert rows[-1]["task_id"] == task_id and rows[-1]["computed"] is True
    assert OrthancHandler.deleted == ["/series/series-Q"]
    assert any(p.endswith("ACC1_3_axial.xlsx") for p in _share_files(pacs_env.share))
    queue.stop()
    assert not (pacs_env.tmp / "ready").exists()
    # a stopped queue keeps its thread handle and does not start again
    # (the reference's LocalQueue.stop; parity)
    assert queue._worker is not None


def test_on_change_imports_no_torch_or_numpy():
    code = ("import sys, types\n"
            "m = types.ModuleType('orthanc')\n"
            "m.RegisterOnChangeCallback = lambda cb: None\n"
            "m.ChangeType = types.SimpleNamespace(STABLE_SERIES=9)\n"
            "sys.modules['orthanc'] = m\n"
            "import boa_tpu_torch.pacs.on_change\n"
            "heavy = sorted({k.split('.')[0] for k in sys.modules}\n"
            "               & {'torch', 'numpy', 'jax', 'boa_tpu'})\n"
            "print(heavy)\n"
            "sys.exit(1 if heavy else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                       text=True, timeout=60)
    assert r.returncode == 0, r.stdout + r.stderr


# ------------------------------------------------------------ Celery and SMB
def _fake_celery():
    mod = types.ModuleType("celery")

    class Conf(dict):
        def update(self, **kw):
            super().update(kw)

    class Celery:
        def __init__(self, broker=None):
            self.broker = broker
            self.conf = Conf()
            self.tasks = {}

        def task(self, fn, name):
            self.tasks[name] = fn
            return types.SimpleNamespace(name=name, fn=fn,
                                         delay=lambda *a: ("published", name, a))

    mod.Celery = Celery
    return mod


def test_celery_app_matches_reference(monkeypatch):
    monkeypatch.setitem(sys.modules, "celery", _fake_celery())
    monkeypatch.setenv("CELERY_BROKER", "amqp://u:p@rabbitmq:5672")
    apps = {}
    for name, (_util, worker) in PACKAGES.items():
        monkeypatch.setattr(worker, "_celery_app", None)
        monkeypatch.setattr(worker, "_celery_task", None)
        app = worker.get_celery_app()
        assert worker.get_celery_app() is app   # registered once
        assert worker.celery is app and worker.celery_app is app
        assert list(app.tasks) == ["analyze_stable_series"]
        assert app.tasks["analyze_stable_series"] is worker.run_analyze_stable_series
        assert worker.analyze_stable_series.delay("r-1") == \
            ("published", "analyze_stable_series", ("r-1",))
        apps[name] = app
    assert apps["port"].conf == apps["ref"].conf
    assert apps["port"].conf["task_acks_late"] is True
    assert apps["port"].conf["worker_prefetch_multiplier"] == 1
    assert apps["port"].conf["worker_max_tasks_per_child"] == 1
    assert apps["port"].broker == apps["ref"].broker


def test_celery_absent_falls_back(monkeypatch):
    monkeypatch.setitem(sys.modules, "celery", None)
    monkeypatch.setattr(tworker, "_celery_app", None)
    monkeypatch.setenv("CELERY_BROKER", "amqp://x")
    assert tworker.get_celery_app() is None
    monkeypatch.delenv("CELERY_BROKER")
    assert tworker.get_celery_app() is None
    with pytest.raises(AttributeError, match="CELERY_BROKER"):
        tworker.celery  # noqa: B018


def test_store_excel_without_smbclient_raises(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "smbclient", None)
    for mod in (tst, jst):
        with pytest.raises(RuntimeError, match="smbclient"):
            mod.store_excel([tmp_path / "x.xlsx"], "/a/")


def test_db_connection_without_psycopg2_or_env(monkeypatch):
    for var in ("POSTGRES_HOST", "POSTGRES_PORT", "POSTGRES_USER", "POSTGRES_PASSWORD",
                "POSTGRES_DATABASE"):
        monkeypatch.setenv(var, "x")
    monkeypatch.setitem(sys.modules, "psycopg2", None)
    assert tutil.get_db_connection() is None
    monkeypatch.delenv("POSTGRES_HOST")
    assert tutil.get_db_connection() is None
    tutil.write_to_postgres(None, {"task_id": "t"})   # no connection: nothing to do


def test_write_to_postgres_rolls_back(monkeypatch):
    calls = []

    class Broken:
        def cursor(self):
            raise RuntimeError("connection lost")

        def rollback(self):
            calls.append("rollback")

    tutil.write_to_postgres(Broken(), {"task_id": "t", "computed": True})
    assert calls == ["rollback"]
    with pytest.raises(KeyError):
        tutil.write_to_postgres(Broken(), {"computed": True})


def test_optional_import():
    from boa_tpu.pacs.imports import optional_import as jopt
    from boa_tpu_torch.pacs.imports import optional_import

    mod, ok = optional_import("json", "dumps")
    assert ok and mod is json.dumps
    missing, ok = optional_import("no_such_module_here")
    assert not ok and not jopt("no_such_module_here")[1]
    with pytest.raises(ImportError, match="no_such_module_here"):
        missing()
    with pytest.raises(ImportError):
        missing.attr  # noqa: B018
