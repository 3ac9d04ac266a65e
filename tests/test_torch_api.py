"""The port's `totalsegmentator()` (boa_tpu_torch/python_api.py) and its
`TotalSegmentator` command (boa_tpu_torch/tools/total_segmentator.py)
against the reference's (boa_tpu/python_api.py, boa_tpu/tools/), one
counterpart for each test of tests/test_python_api.py, with
`device="cpu"`, plus the radiomics, the writers and the preview through the
API, `--radiomics` through the CLI, the parser, and the device rule.

Bars: NIfTI files byte-identical; statistics.json volumes equal and
intensities within 1e-3 HU (tests/test_torch_statistics.py's bars);
statistics_radiomics.json counts equal and features within 1e-9 relative;
skin masks identical; DICOM-SEG labels equal and RTSTRUCT ContourData
equal; labels of real synthetic weights agreeing > 0.995.
"""

import functools
import json
import pickle

import numpy as np
import pytest
import torch

from boa_tpu import python_api as japi
from boa_tpu.io import nifti as jn
from boa_tpu.tools import total_segmentator as jts
from boa_tpu_torch import python_api as tapi
from boa_tpu_torch.device import named_device
from boa_tpu_torch.io import nifti as tn
from boa_tpu_torch.tools import total_segmentator as tts
from boa_tpu_torch.weights.store import ModelStore


@pytest.fixture(autouse=True)
def config_dir(tmp_path, monkeypatch):
    """predict_image counts predictions in the install config: a folder of
    each test's own."""
    monkeypatch.setenv("BOA_TPU_CONFIG_DIR", str(tmp_path / "cfg"))
    monkeypatch.delenv("LICENSE_NUMBER", raising=False)


@pytest.fixture()
def study(tmp_path):
    data = np.full((40, 36, 32), -1000, np.int16)
    data[8:32, 8:28, :] = 40
    data[12:20, 10:20, 4:28] = np.random.default_rng(0).integers(-50, 300, (8, 10, 24))
    img = tn.NiftiImage(data=data, affine=np.diag([-1.5, -1.5, 3.0, 1.0]))
    p = tmp_path / "ct.nii.gz"
    tn.save(img, p)
    return p


def _fake(vol, spacing, task_id):
    seg = np.zeros(vol.shape, np.uint8)
    nx, ny, nz = vol.shape
    seg[nx // 4:nx // 2, ny // 4:ny // 2, nz // 4:nz // 2] = 1   # spleen
    seg[nx // 2:3 * nx // 4, ny // 2:3 * ny // 4, nz // 4:3 * nz // 4] = 5  # liver
    return seg


def _both(tmp_path, inp, out_name, **kw):
    """(port result, reference result, port output, reference output) of the
    same call; `out_name` None for no output."""
    outs = [None, None]
    if out_name is not None:
        outs = [tmp_path / "port" / out_name, tmp_path / "ref" / out_name]
    got = tapi.totalsegmentator(inp, outs[0], device="cpu", **kw)
    want = japi.totalsegmentator(inp, outs[1], **kw)
    return got, want, outs[0], outs[1]


def _same_files(got_dir, want_dir):
    names = sorted(p.name for p in want_dir.iterdir())
    assert sorted(p.name for p in got_dir.iterdir()) == names
    for name in names:
        if name.endswith(".nii.gz"):
            assert (got_dir / name).read_bytes() == (want_dir / name).read_bytes(), name
    return names


def _same_stats(got: dict, want: dict, atol=1e-3):
    assert list(got) == list(want)
    for name, w in want.items():
        assert got[name]["volume"] == w["volume"], name
        np.testing.assert_allclose(got[name]["intensity"], w["intensity"], atol=atol,
                                   err_msg=name)


def _same_radiomics(got, want, path=""):
    if isinstance(want, dict):
        assert list(got) == list(want), path
        for k in want:
            _same_radiomics(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, bool) or path.endswith("/voxels"):
        assert got == want, path
    else:
        assert got == pytest.approx(want, rel=1e-9, abs=1e-12), path


def test_api_multilabel(study, tmp_path):
    (seg, stats), (ref_seg, ref_stats), out, ref_out = _both(
        tmp_path, study, "seg.nii.gz", task="total", fast=True, ml=True, statistics=True,
        fake_predict=_fake)
    assert stats["liver"]["volume"] > 0
    assert set(np.unique(tn.load(out).data)) == {0, 1, 5}
    assert out.read_bytes() == ref_out.read_bytes()
    np.testing.assert_array_equal(seg.data, ref_seg.data)
    _same_stats(stats, ref_stats)
    _same_stats(json.loads((out.parent / "statistics.json").read_text()),
                json.loads((ref_out.parent / "statistics.json").read_text()))


def test_api_binary_masks_and_roi_subset(study, tmp_path):
    _, _, out, ref_out = _both(tmp_path, study, "masks", task="total", fast=True, ml=False,
                               roi_subset=["liver"], fake_predict=_fake)
    assert _same_files(out, ref_out) == ["liver.nii.gz"]
    assert set(np.unique(tn.load(out / "liver.nii.gz").data)) == {0, 1}


@pytest.mark.parametrize("threads", [1, 6])
def test_api_per_class_masks_on_threads(study, tmp_path, threads):
    """Every class of the map gets its file, byte-identical to the
    reference's, however many threads write them."""
    _, _, out, ref_out = _both(tmp_path, study, "masks", task="total", fast=True,
                               nr_thr_saving=threads, fake_predict=_fake)
    assert len(_same_files(out, ref_out)) == 117


@pytest.mark.parametrize("dtype,bar", [("float32", 0.995), ("bfloat16", 0.99)])
def test_api_real_weights(tmp_path, monkeypatch, dtype, bar):
    """The reference test's model (task 298, widths 4/8, 16^3 patch, 6 mm)
    written once by the reference's create_synthetic_model (its seeds and
    init), its seg head biased as bench.py does (N(0, 3), seed 7) so that
    the labels form regions instead of near-tied noise, read by both
    packages. The API runs `predict_image` at its default bfloat16, where
    the bar is the repo's for the bf16 forward (> 0.99,
    tests/test_torch_pipeline.py); with `predict_image` pinned to float32 in
    both packages the labels agree > 0.995. The port's own
    create_synthetic_model (numpy init, same seeds) gives a model the port
    runs on the original grid."""
    from boa_tpu.inference import pipeline as jpipe
    from boa_tpu_torch.inference import pipeline as tpipe

    for mod in (jpipe, tpipe):
        monkeypatch.setattr(mod, "predict_image", functools.partial(
            mod.predict_image, compute_dtype=dtype))
    from boa_tpu.plans.plans import ModelPlans
    from boa_tpu.weights import convert as jcv
    from boa_tpu.weights.store import ModelStore as JStore
    from boa_tpu.weights.store import create_synthetic_model as jcreate
    from boa_tpu_torch.weights.store import create_synthetic_model as tcreate

    kw = dict(num_classes=5, trainer="nnUNetTrainer_4000epochs_NoMirroring",
              patch_size=(16, 16, 16), spacing=(6.0, 6.0, 6.0), features=(4, 8))
    mdir = jcreate(tmp_path / "w", 298, "fastest", **kw)
    path = mdir / "fold_0" / "checkpoint_final.npz"
    p0 = jcv.load_params_npz(path, ModelPlans.from_model_folder(mdir).arch_config())
    head = p0["seg_heads"][-1]
    head["b"] = head["b"] + np.random.default_rng(7).normal(0, 3.0, head["b"].shape
                                                           ).astype(np.float32)
    jcv.save_params_npz(p0, path)
    data = np.full((40, 36, 32), -1000, np.int16)
    data[8:32, 8:28, :] = 40
    img = tn.NiftiImage(data=data, affine=np.diag([-1.5, -1.5, 3.0, 1.0]))
    jimg = jn.NiftiImage(data=data, affine=img.affine.copy())
    seg = tapi.totalsegmentator(img, None, task="total", fastest=True, device="cpu",
                                store=ModelStore(tmp_path / "w"))
    ref = japi.totalsegmentator(jimg, None, task="total", fastest=True,
                                store=JStore(tmp_path / "w"))
    assert seg.shape == img.shape
    assert float((np.asarray(seg.data) == np.asarray(ref.data)).mean()) > bar
    assert len(np.unique(ref.data)) > 1
    tcreate(tmp_path / "w2", 298, "fastest", **kw)
    own = tapi.totalsegmentator(img, None, task="total", fastest=True, device="cpu",
                                store=ModelStore(tmp_path / "w2"))
    assert own.shape == img.shape and own.get_label_map() == seg.get_label_map()


def test_api_license_gate(study, capsys):
    for api in (tapi, japi):
        with pytest.raises(SystemExit):
            api.totalsegmentator(study, None, task="heartchambers_highres",
                                 fake_predict=_fake, **({"device": "cpu"} if api is tapi
                                                       else {}))
    assert "boa_tpu_torch.tools.set_license" in capsys.readouterr().out


def test_api_v1_order(study, tmp_path):
    from boa_tpu_torch.tasks import class_maps

    seg_v1, ref_v1, _, _ = _both(tmp_path, study, None, task="total", fast=True,
                                 v1_order=True, fake_predict=_fake)
    seg_v2 = tapi.totalsegmentator(study, None, task="total", fast=True, device="cpu",
                                   fake_predict=_fake)
    np.testing.assert_array_equal(seg_v1.data, ref_v1.data)
    m2, m1 = class_maps.get_class_map("total"), class_maps.get_class_map("total_v1")
    inv1 = {v: k for k, v in m1.items()}
    d2, d1 = np.asarray(seg_v2.data), np.asarray(seg_v1.data)
    for lb in np.unique(d2):
        if lb:
            assert set(np.unique(d1[d2 == lb])) == {inv1.get(m2[int(lb)], 0)}
    assert seg_v1.get_label_map() == ref_v1.get_label_map() == m1


def test_api_skip_saving_and_test_hook(study, tmp_path):
    seg, ref, out, _ = _both(tmp_path, study, "masks", task="total", fast=True,
                             skip_saving=True, test=1)
    assert not out.exists()
    assert np.asarray(seg.data).max() == 1
    np.testing.assert_array_equal(seg.data, ref.data)


def test_api_remove_small_blobs(study, tmp_path):
    def speckled(vol, spacing, task_id):
        seg = _fake(vol, spacing, task_id)
        seg[0, 0, 0] = 1
        return seg

    seg, ref, _, _ = _both(tmp_path, study, None, task="total", fast=True,
                           remove_small_blobs=True, fake_predict=speckled)
    assert np.asarray(seg.data)[0, 0, 0] == 0
    np.testing.assert_array_equal(seg.data, ref.data)


def test_api_save_probabilities(study, tmp_path):
    paths = [tmp_path / "port.npz", tmp_path / "ref.npz"]
    tapi.totalsegmentator(study, None, task="total", fast=True, device="cpu",
                          save_probabilities=paths[0], fake_predict=_fake)
    japi.totalsegmentator(study, None, task="total", fast=True,
                          save_probabilities=paths[1], fake_predict=_fake)
    got, want = (np.load(p)["probabilities"] for p in paths)
    assert got.dtype == want.dtype == np.float16 and got.ndim == 4
    np.testing.assert_array_equal(got, want)
    with open(paths[0].with_suffix(".pkl"), "rb") as fh:
        props = pickle.load(fh)
    assert "spacing" in props


def test_api_crop_path_reuse(study, tmp_path):
    img = tn.load(study)
    mask = np.zeros(img.shape, np.uint8)
    mask[10:30, 10:26, 8:28] = 1
    crop_dir = tmp_path / "crops"
    crop_dir.mkdir()
    tn.save(tn.NiftiImage(data=mask, affine=img.affine.copy()), crop_dir / "crop_mask.nii.gz")
    calls = []

    def counting_fake(vol, spacing, task_id):
        calls.append(vol.shape)
        return _fake(vol, spacing, task_id)

    seg, ref, _, _ = _both(tmp_path, study, None, task="total", fast=True,
                           crop_path=crop_dir, fake_predict=counting_fake)
    assert len(calls) == 2 and calls[0] == calls[1]   # port, then reference
    assert np.prod(calls[0]) < np.prod(img.shape)
    np.testing.assert_array_equal(seg.data, ref.data)


def test_api_normalized_intensity_statistics(study, tmp_path):
    (_, stats), (_, ref_stats), _, _ = _both(
        tmp_path, study, None, task="total", fast=True, statistics=True,
        statistics_normalized_intensities=True, fake_predict=_fake)
    vals = [e["intensity"] for e in stats.values() if e["volume"] > 0]
    assert vals and all(0.0 <= v <= 1.0 for v in vals)
    ct = tn.load(study).data
    _same_stats(stats, ref_stats, atol=1e-3 / (float(ct.max()) - float(ct.min())))


def test_api_statistics_on_the_original_grid(study, tmp_path):
    """Without `fast` the statistics come from the original grid, median
    aggregation, border classes kept."""
    (_, stats), (_, ref_stats), _, _ = _both(
        tmp_path, study, None, task="total", statistics=True, stats_aggregation="median",
        statistics_exclude_masks_at_border=False, fake_predict=_fake)
    _same_stats(stats, ref_stats)
    assert sum(v["volume"] > 0 for v in stats.values()) >= 2


def test_api_dicom_series_input_and_dicom_outputs(tmp_path):
    """DICOM directory in -> nifti, dicom_seg and dicom_rtstruct out: the
    NIfTI byte-identical, the SEG's labels and the RTSTRUCT's contours as
    the reference's; a NIfTI input cannot ask for DICOM objects."""
    from boa_tpu.io import dicom as jd
    from boa_tpu.io import dicom_seg as jseg
    from boa_tpu_torch.io import dicom_io as tio
    from boa_tpu_torch.io import dicom_seg as tseg

    data = np.full((32, 32, 12), -1000, np.int16)
    data[8:24, 8:24, :] = 40
    img = tn.NiftiImage(data=data, affine=np.diag([-1.0, -1.0, 3.0, 1.0]))
    dcm_dir = tmp_path / "dicoms"
    dcm_dir.mkdir()
    tio.write_ct_series(img, dcm_dir)

    def ring(vol, spacing, task_id):   # a ring with a hole: outer and hole contours
        seg = _fake(vol, spacing, task_id)
        seg[seg.shape[0] // 2 + 1, seg.shape[1] // 2 + 1, :] = 0
        return seg

    spans = {}
    _, _, out, ref_out = _both(tmp_path, dcm_dir, "out", task="total", fast=True, ml=True,
                               output_type=["nifti", "dicom_seg", "dicom_rtstruct"],
                               fake_predict=ring)
    tapi.totalsegmentator(dcm_dir, tmp_path / "again", task="total", fast=True, ml=True,
                          output_type=["nifti", "dicom_seg", "dicom_rtstruct"],
                          fake_predict=ring, device="cpu", spans=spans)
    assert {"save_nifti", "save_dicom_seg", "save_dicom_rtstruct", "contours"} <= set(spans)
    assert (out / "total_segmentation.nii.gz").read_bytes() == \
        (ref_out / "total_segmentation.nii.gz").read_bytes()
    seg_ds = jd.dcmread(out / "total_segmentation_seg.dcm")
    ref_ds = jd.dcmread(ref_out / "total_segmentation_seg.dcm")
    labels, lmap = tseg.read_seg_labelmap(seg_ds)
    ref_labels, ref_lmap = jseg.read_seg_labelmap(ref_ds)
    np.testing.assert_array_equal(labels, ref_labels)
    assert lmap == ref_lmap and set(np.unique(labels)) >= {0, 1}
    assert seg_ds.get("PixelData") == ref_ds.get("PixelData")
    rt = jd.dcmread(out / "total_segmentation_rtstruct.dcm")
    ref_rt = jd.dcmread(ref_out / "total_segmentation_rtstruct.dcm")
    assert [r.ROIName for r in rt.StructureSetROISequence] == \
        [r.ROIName for r in ref_rt.StructureSetROISequence]
    n = 0
    for a, b in zip(rt.ROIContourSequence, ref_rt.ROIContourSequence):
        assert [c.ContourData for c in a.ContourSequence] == \
            [c.ContourData for c in b.ContourSequence]
        n += len(a.ContourSequence)
    assert n > 12   # every slice of the ring holds an outer and a hole contour
    for api, nim, kw in ((tapi, tn, {"device": "cpu"}), (japi, jn, {})):
        with pytest.raises(ValueError):
            api.totalsegmentator(nim.NiftiImage(data=data, affine=img.affine), out,
                                 output_type="dicom_seg", fake_predict=_fake, **kw)


def test_api_derived_body_masks(tmp_path):
    data = np.full((40, 36, 20), -1000, np.int16)
    data[8:32, 8:28, :] = 40
    img = tn.NiftiImage(data=data, affine=np.diag([1.5, 1.5, 3.0, 1.0]))
    p = tmp_path / "ct.nii.gz"
    tn.save(img, p)

    def body_fake(vol, spacing, task_id):
        seg = np.zeros(vol.shape, np.uint8)
        seg[8:32, 8:28, :] = 1
        seg[2:5, 2:5, :] = 2
        return seg

    _, _, out, ref_out = _both(tmp_path, p, "masks", task="body", fake_predict=body_fake)
    names = _same_files(out, ref_out)
    assert {"body_trunc.nii.gz", "body.nii.gz", "skin.nii.gz"} <= set(names)
    assert np.asarray(tn.load(out / "skin.nii.gz").data).sum() > 0
    _, _, out2, _ = _both(tmp_path, p, "masks2", task="body", no_derived_masks=True,
                          fake_predict=body_fake)
    assert not (out2 / "skin.nii.gz").exists()


def test_extract_skin_equal():
    from boa_tpu.ops.postprocessing import extract_skin as jskin
    from boa_tpu_torch.ops.postprocessing import extract_skin as tskin

    rng = np.random.default_rng(4)
    ct = rng.integers(-400, 400, (30, 28, 20)).astype(np.int16)
    body = np.zeros(ct.shape, bool)
    body[4:26, 5:24, 2:18] = True
    body[10:12, 10:12, :] = False
    np.testing.assert_array_equal(tskin(ct, body), jskin(ct, body))


def test_api_radiomics_and_preview(study, tmp_path):
    """radiomics=True writes statistics_radiomics.json equal to the
    reference's; preview=True writes the port's preview_total.png; the
    spans name each stage."""
    spans = {}
    out, ref_out = tmp_path / "port" / "masks", tmp_path / "ref" / "masks"
    tapi.totalsegmentator(study, out, task="total", fast=True, statistics=True,
                          radiomics=True, preview=True, fake_predict=_fake, device="cpu",
                          spans=spans)
    japi.totalsegmentator(study, ref_out, task="total", fast=True, statistics=True,
                          radiomics=True, fake_predict=_fake)
    _same_radiomics(json.loads((out / "statistics_radiomics.json").read_text()),
                    json.loads((ref_out / "statistics_radiomics.json").read_text()))
    _same_stats(json.loads((out / "statistics.json").read_text()),
                json.loads((ref_out / "statistics.json").read_text()))
    assert (out / "preview_total.png").read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert {"predict", "statistics", "radiomics_histogram", "radiomics_shape", "save_nifti",
            "preview_fronts", "preview_render"} <= set(spans)
    for api, kw in ((tapi, {"device": "cpu"}), (japi, {})):
        with pytest.raises(ValueError, match="multilabel"):
            api.totalsegmentator(study, out, ml=True, radiomics=True, fake_predict=_fake,
                                 **kw)


def test_cli_total_segmentator(study, tmp_path, monkeypatch):
    out, ref_out = tmp_path / "port" / "seg.nii.gz", tmp_path / "ref" / "seg.nii.gz"
    monkeypatch.setattr("boa_tpu_torch.python_api._test_fake_predict", _fake)
    monkeypatch.setattr("boa_tpu.python_api._test_fake_predict", _fake)
    args = ["-i", str(study), "-ml", "-ta", "total", "--fast", "--test", "1",
            "--statistics", "-q"]
    tts.main(["-o", str(out), "-d", "cpu", *args])
    jts.main(["-o", str(ref_out), *args])
    assert out.read_bytes() == ref_out.read_bytes()
    _same_stats(json.loads((out.parent / "statistics.json").read_text()),
                json.loads((ref_out.parent / "statistics.json").read_text()))


def test_cli_parser_matches_reference():
    """The same flags, destinations, defaults (the device's is the card's
    "gpu" where the reference's is "tpu"), choices and nargs."""
    def table(parser):
        return {a.dest: (tuple(a.option_strings), a.default, a.choices, a.nargs, a.type,
                         a.required) for a in parser._actions}

    got, want = table(tts.get_parser()), table(jts.get_parser())
    assert got.pop("device")[1] == "gpu" and want.pop("device")[1] == "tpu"
    assert got == want


def test_cli_set_license_and_setup(tmp_path, monkeypatch):
    from boa_tpu.utils import persistent_config as jpc
    from boa_tpu_torch.tools import set_license, setup_manually
    from boa_tpu_torch.utils import persistent_config

    monkeypatch.setenv("BOA_TPU_CONFIG_DIR", str(tmp_path))
    set_license.main(["-l", "aca_00000000000000", "-sv"])
    assert persistent_config.get_license_number() == "aca_00000000000000"
    assert jpc.get_license_number() == "aca_00000000000000"   # one file for both
    setup_manually.main(["-id", "totalseg_12345678"])
    assert persistent_config.get_config_key("boa_tpu_id") == "totalseg_12345678"
    with pytest.raises(ValueError):
        set_license.main(["-l", "bad_license", "-sv"])
    with pytest.raises(ValueError):
        setup_manually.main(["-id", "nope_1"])


def test_combine_masks_equal(tmp_path):
    """combine_masks over a mask folder and a labelled multilabel file, and
    combine_masks_to_multilabel_file, as the reference's."""
    from boa_tpu.tools import combine_masks as jcm
    from boa_tpu_torch.tools import combine_masks as tcm

    aff = np.diag([1.5, 1.5, 3.0, 1.0])
    rng = np.random.default_rng(5)
    for name in ("lung_upper_lobe_left", "lung_lower_lobe_left", "liver"):
        tn.save(tn.NiftiImage(data=(rng.random((12, 10, 8)) > 0.7).astype(np.uint8),
                              affine=aff), tmp_path / f"{name}.nii.gz")
    np.testing.assert_array_equal(tcm.combine_masks(tmp_path, "lung_left").data,
                                  jcm.combine_masks(tmp_path, "lung_left").data)
    for mod in (tcm, jcm):
        with pytest.raises(FileNotFoundError):
            mod.combine_masks(tmp_path, "lung_right")
    port, ref = tmp_path / "port" / "ml.nii.gz", tmp_path / "ref" / "ml.nii.gz"
    port.parent.mkdir()
    ref.parent.mkdir()
    tcm.main(["-i", str(tmp_path), "-o", str(port), "-m", "multilabel"])
    jcm.combine_masks_to_multilabel_file(tmp_path, ref)
    assert port.read_bytes() == ref.read_bytes()   # gzip headers carry the file name
    np.testing.assert_array_equal(tcm.combine_masks(port, "lung_left").data,
                                  jcm.combine_masks(ref, "lung_left").data)


def test_cli_radiomics_through_the_anatomy_hook(tmp_path, monkeypatch):
    """`python -m boa_tpu_torch --radiomics` (cli.run) through the anatomy
    hook writes statistics_radiomics.json over the label files, equal to
    the reference CLI's; a DICOM directory input raises there in both, as
    the reference reads the input as NIfTI (ROADMAP Queue 3)."""
    from boa_tpu import cli as jcli
    from boa_tpu_torch import cli as tcli
    from boa_tpu_torch.io import dicom_io as tio
    from boa_tpu_torch.testing import anatomy as tanat

    monkeypatch.setenv("BOA_TEST_ANATOMY", "1")
    monkeypatch.setenv("SKIP_CONTRAST_INFORMATION", "1")
    shape, spacing = (96, 96, 32), (3.5, 3.5, 9.0)
    ct = tanat.synth_ct(shape=shape, spacing=spacing)
    tn.save(tn.NiftiImage(data=ct, affine=np.diag([*spacing, 1.0])), tmp_path / "ct.nii.gz")
    args = ["-i", str(tmp_path / "ct.nii.gz"), "-m", "total", "--fast-total", "--radiomics"]
    tcli.run([*args, "-o", str(tmp_path / "port"), "--device", "cpu"])
    jcli.run([*args, "-o", str(tmp_path / "ref")])
    got = json.loads((tmp_path / "port" / "statistics_radiomics.json").read_text())
    want = json.loads((tmp_path / "ref" / "statistics_radiomics.json").read_text())
    assert "total" in want and sum(v["present"] for v in want["total"].values()) > 20
    _same_radiomics(got, want)

    series = tmp_path / "series"
    tio.write_ct_series(tn.NiftiImage(data=ct[:, :, :12], affine=np.diag([*spacing, 1.0])),
                        series)
    for run, kw in ((tcli.run, ["--device", "cpu"]), (jcli.run, [])):
        with pytest.raises(IsADirectoryError):
            run(["-i", str(series), "-o", str(tmp_path / "dcm"), "-m", "total",
                 "--fast-total", "--radiomics", *kw])


def test_device_rule(study, monkeypatch):
    """"tpu" and other names raise ValueError; "gpu", "cuda", "gpu:N" are the
    card, which raises RuntimeError without CUDA; "cpu" is the host."""
    for bad in ("tpu", "mps", "gpu:x", "cpu:0", ""):
        with pytest.raises(ValueError):
            tapi.totalsegmentator(study, None, fast=True, device=bad, fake_predict=_fake)
    assert named_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for card in ("gpu", "cuda", "gpu:1"):
        with pytest.raises(RuntimeError, match="CUDA"):
            named_device(card)
    with pytest.raises(RuntimeError, match="CUDA"):
        tapi.totalsegmentator(study, None, fast=True, fake_predict=_fake)
