"""The port's weights commands against the reference on the CPU:
`export_trained_model` (the store entry equal to the reference's, and
served by `predict_image` as the reference serves its own), the manager's
download from a localhost HTTP server (no network), import, list,
create-synthetic and export commands with their device rule, and the
sharing zips (byte-equal to the reference's, installed, refused on a
zip-slip member, fetched from localhost)."""

import http.server
import json
import threading
import zipfile
from pathlib import Path

import numpy as np
import pytest
import torch

from boa_tpu_torch.weights.convert import _flatten, load_params_npz

TOTAL_FAST_TRAINER = "nnUNetTrainer_4000epochs_NoMirroring"


def _serve_dir(directory):
    handler = lambda *a, **k: http.server.SimpleHTTPRequestHandler(  # noqa: E731
        *a, directory=str(directory), **k)
    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}"


def _same_npz(a: Path, b: Path) -> None:
    x, y = {}, {}
    _flatten(load_params_npz(a), "", x)
    _flatten(load_params_npz(b), "", y)
    assert x.keys() == y.keys()
    for k in x:
        np.testing.assert_array_equal(x[k], y[k], err_msg=k)


def _same_entry(a: Path, b: Path) -> None:
    for name in ("plans.json", "dataset.json"):
        assert (a / name).read_bytes() == (b / name).read_bytes(), name
    folds = sorted(p.name for p in a.glob("fold_*"))
    assert folds == sorted(p.name for p in b.glob("fold_*")) and folds
    for f in folds:
        _same_npz(a / f / "checkpoint_final.npz", b / f / "checkpoint_final.npz")


@pytest.fixture()
def trained(tmp_path):
    """A tiny run of the port's training on a preprocessed store with plans
    and dataset.json beside it, as plan_and_preprocess leaves them."""
    from boa_tpu_torch.train.dataset import CaseStore
    from boa_tpu_torch.train.run_training import run_training

    prep = tmp_path / "prep"
    st = CaseStore(prep / "cases")
    r = np.random.default_rng(1)
    for i in range(2):
        seg = np.zeros((20, 20, 20), np.int8)
        seg[4:12, 4:12, 4:12] = 1
        seg[12:18, 10:18, 6:14] = 2
        st.save_case(f"c{i}", (seg * 1.5 + r.normal(size=seg.shape) * 0.3).astype(np.float32),
                     seg)
    (prep / "plans.json").write_text(json.dumps({
        "configurations": {"3d_fullres": {"spacing": [2.0, 2.0, 2.5]}},
        "foreground_intensity_properties_per_channel": {
            "0": {"mean": 50.0, "std": 120.0, "percentile_00_5": -200.0,
                  "percentile_99_5": 400.0, "min": -300.0, "max": 500.0,
                  "median": 40.0}}}))
    (prep / "dataset.json").write_text(json.dumps(
        {"labels": {"background": 0, "liver": 1, "spleen": 2}}))
    out = tmp_path / "train"
    run_training(prep / "cases", out, patch=(16, 16, 16), epochs=1, iters=2,
                 features=(4, 8), device="cpu", compute_dtype="float32")
    return out


def test_export_trained_model_equal_to_reference(trained, tmp_path):
    from boa_tpu.weights.store import export_trained_model as ref_export
    from boa_tpu_torch.weights.store import export_trained_model

    a = export_trained_model(trained, 901, "toy", root=tmp_path / "a")
    b = ref_export(trained, 901, "toy", root=tmp_path / "b")
    assert a.relative_to(tmp_path / "a") == b.relative_to(tmp_path / "b")
    _same_entry(a, b)
    plans = json.loads((a / "plans.json").read_text())
    assert plans["configurations"]["3d_fullres"]["spacing"] == [2.0, 2.0, 2.5]
    assert json.loads((a / "dataset.json").read_text())["labels"]["spleen"] == 2


def test_exported_model_served_by_predict_image(trained, tmp_path):
    """`manager export` as task 297's trainer: `predict_image(img, "total",
    fast=True)` serves it on the CPU in float32, as the reference serves the
    reference's export of the same checkpoint."""
    from boa_tpu.inference.pipeline import predict_image as ref_predict
    from boa_tpu.io.nifti import NiftiImage as RefImage
    from boa_tpu.weights.store import ModelStore as RefStore
    from boa_tpu.weights.store import export_trained_model as ref_export
    from boa_tpu_torch.inference.pipeline import predict_image
    from boa_tpu_torch.io.nifti import NiftiImage
    from boa_tpu_torch.weights.manager import main
    from boa_tpu_torch.weights.store import ModelStore

    main(["export", str(trained), "--task-id", "297", "--name", "trained", "--root",
          str(tmp_path / "a"), "--trainer", TOTAL_FAST_TRAINER, "-d", "cpu"])
    ref_export(trained, 297, "trained", root=tmp_path / "b", trainer=TOTAL_FAST_TRAINER)
    r = np.random.default_rng(2)
    data = np.full((44, 40, 20), -1000, np.int16)
    data[6:38, 6:34, 2:18] = r.integers(-100, 400, (32, 28, 16))
    aff = np.diag([3.0, 3.0, 3.0, 1.0])
    got = predict_image(NiftiImage(data=data, affine=aff), "total", ModelStore(tmp_path / "a"),
                        fast=True, compute_dtype="float32", device="cpu")
    want = ref_predict(RefImage(data=data, affine=aff), "total", RefStore(tmp_path / "b"),
                       fast=True, compute_dtype="float32")
    a, b = np.asarray(got.seg.data), np.asarray(want.seg.data)
    assert a.shape == b.shape == data.shape
    assert (a == b).mean() > 0.999


def _release(tmp_path, task_id=901):
    """A release zip: DatasetXXX_Toy/trainer__plans__conf with a
    `checkpoint_final.pth` fold in nnU-Net's own format."""
    from boa_tpu_torch.plans.plans import synthetic_plans
    from boa_tpu_torch.testing.nnunet_checkpoint import save_checkpoint
    from boa_tpu_torch.weights.store import init_params_numpy

    plans = synthetic_plans(num_classes=3, patch_size=(16, 16, 16), features=(4, 8))
    cfg = plans.arch_config()
    params = init_params_numpy(cfg, 5)
    src = tmp_path / "release" / f"Dataset{task_id}_Toy"
    mdir = src / "nnUNetTrainer__nnUNetPlans__3d_fullres"
    (mdir / "fold_0").mkdir(parents=True)
    (mdir / "plans.json").write_text(json.dumps(plans.plans))
    (mdir / "dataset.json").write_text(json.dumps(plans.dataset))
    save_checkpoint(mdir / "fold_0" / "checkpoint_final.pth", params, cfg)
    zpath = tmp_path / "release" / f"Dataset{task_id}_Toy.zip"
    with zipfile.ZipFile(zpath, "w") as z:
        for p in sorted(src.rglob("*")):
            if p.is_file():
                z.write(p, p.relative_to(src.parent))
    return mdir, params


def test_manager_download_and_import_equal_to_reference(tmp_path, monkeypatch):
    from boa_tpu.weights import manager as rman
    from boa_tpu.weights.store import import_torch_model_folder as ref_import
    from boa_tpu_torch.weights import manager

    mdir, params = _release(tmp_path)
    srv, base = _serve_dir(tmp_path / "release")
    try:
        url = ("Dataset901_Toy", f"{base}/Dataset901_Toy.zip")
        monkeypatch.setitem(manager.WEIGHT_URLS, 901, url)
        monkeypatch.setitem(rman.WEIGHT_URLS, 901, url)
        got = manager.download_task_weights(901, root=tmp_path / "a")
        want = rman.download_task_weights(901, root=tmp_path / "b")
        assert manager.download_task_weights(901, root=tmp_path / "a") == got   # present
    finally:
        srv.shutdown()
    sub = "nnUNetTrainer__nnUNetPlans__3d_fullres"
    _same_entry(got / sub, want / sub)
    x = {}
    _flatten(load_params_npz(got / sub / "fold_0" / "checkpoint_final.npz"), "", x)
    y = {}
    _flatten(params, "", y)
    for k in y:
        np.testing.assert_array_equal(x[k], y[k])
    # import of the local folder, through the command
    manager.main(["import", str(mdir), "--root", str(tmp_path / "c"), "-d", "cpu"])
    ref_import(mdir, tmp_path / "d")
    _same_entry(tmp_path / "c" / "Dataset901_Toy" / sub, tmp_path / "d" / "Dataset901_Toy" / sub)
    # a zip with a member outside the store is refused
    evil = tmp_path / "release" / "evil.zip"
    with zipfile.ZipFile(evil, "w") as z:
        z.writestr("../outside.txt", "nope")
    srv, base = _serve_dir(tmp_path / "release")
    try:
        monkeypatch.setitem(manager.WEIGHT_URLS, 902, ("Dataset902_X", f"{base}/evil.zip"))
        with pytest.raises(ValueError, match="unsafe"):
            manager.download_task_weights(902, root=tmp_path / "e")
    finally:
        srv.shutdown()
    assert not (tmp_path / "outside.txt").exists()


def test_manager_list_create_synthetic_and_device_rule(tmp_path, monkeypatch, capsys):
    from boa_tpu.plans.plans import synthetic_plans as ref_plans
    from boa_tpu.inference.pipeline import class_map_for_task
    from boa_tpu_torch.weights import manager

    monkeypatch.setenv("BOA_WEIGHTS_PATH", str(tmp_path / "w"))
    manager.main(["create-synthetic", "--task", "body_fast", "-d", "cpu"])
    mdir = next((tmp_path / "w").glob("Dataset*/*__*__3d_fullres"))
    names = ["background"] + list(class_map_for_task("body_fast").values())
    from boa_tpu.tasks.registry import TASKS

    cfg = TASKS["body_fast"]
    want = ref_plans(num_classes=len(names), patch_size=(128, 128, 128),
                     spacing=cfg.resample or (1.5, 1.5, 1.5),
                     features=(32, 64, 128, 256, 320, 320), label_names=names)
    assert (mdir / "plans.json").read_text() == json.dumps(want.plans)
    assert (mdir / "dataset.json").read_text() == json.dumps(want.dataset)
    manager.main(["list"])
    out = capsys.readouterr().out
    assert mdir.parent.name in out and "checked 1 fold(s) on cpu" in out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        manager.main(["import", str(mdir)])
    with pytest.raises(RuntimeError, match="CUDA"):
        manager.main(["export", str(tmp_path), "--task-id", "1", "--name", "x"])
    manager.main(["list"])   # reads no weights


def test_sharing_zip_equal_to_reference_and_installs(tmp_path):
    from boa_tpu.weights import sharing as rsh
    from boa_tpu_torch.weights import sharing
    from boa_tpu_torch.weights.store import ModelStore, create_synthetic_model

    store = tmp_path / "store"
    mdir = create_synthetic_model(store, 991, "demo", num_classes=3, n_folds=2,
                                  features=(4, 8), patch_size=(16, 16, 16))
    val = mdir / "fold_0" / "validation"
    val.mkdir()
    (val / "summary.json").write_text("{}")
    (mdir / "fold_1" / "debug.json").write_text("{}")
    a = sharing.export_pretrained_model(991, tmp_path / "a.zip", folds=(0, 1), root=store)
    b = rsh.export_pretrained_model(991, tmp_path / "b.zip", folds=(0, 1), root=store)
    assert a.read_bytes() == b.read_bytes()
    with pytest.raises(FileNotFoundError):
        sharing.export_pretrained_model(991, tmp_path / "x.zip", configurations=("2d",),
                                        folds=(0,), root=store)
    sharing.install_model_from_zip(a, root=tmp_path / "inst")
    plans, params = ModelStore(tmp_path / "inst").load(991, folds=(0, 1))
    assert len(params) == 2 and plans.arch_config().num_classes == 3
    evil = tmp_path / "evil.zip"
    with zipfile.ZipFile(evil, "w") as zf:
        zf.writestr("../outside.txt", "nope")
    with pytest.raises(ValueError, match="unsafe"):
        sharing.install_model_from_zip(evil, root=tmp_path / "store2")
    assert not (tmp_path / "outside.txt").exists()
    srv, base = _serve_dir(tmp_path)
    try:
        sharing.download_and_install_from_url(f"{base}/a.zip", root=tmp_path / "dl")
    finally:
        srv.shutdown()
    sub = "Dataset991_demo/nnUNetTrainer__nnUNetPlans__3d_fullres"
    _same_entry(tmp_path / "dl" / sub, store / sub)


def test_sharing_main(tmp_path, monkeypatch):
    from boa_tpu_torch.weights import sharing
    from boa_tpu_torch.weights.store import create_synthetic_model

    monkeypatch.setenv("BOA_WEIGHTS_PATH", str(tmp_path / "store"))
    create_synthetic_model(tmp_path / "store", 992, "demo", num_classes=3,
                           features=(4, 8), patch_size=(16, 16, 16))
    sharing.main(["export", "-d", "992", "-o", str(tmp_path / "m.zip"), "-f", "0"])
    monkeypatch.setenv("BOA_WEIGHTS_PATH", str(tmp_path / "other"))
    sharing.main(["install", str(tmp_path / "m.zip")])
    assert (tmp_path / "other" / "Dataset992_demo").is_dir()
