"""The port's BCA chain (boa_tpu_torch/bca, its tables, the connected
components it adds and its anatomy phantom) against the reference
(boa_tpu/bca with its native library where it is built), same numpy inputs
from a seed, on the CPU.

Bars: tables, postprocessed labels, tissue maps, per-slice voxel counts and
volumes, density stacks, findings and vertebra windows equal; HU sums
within 1e-6 relative (the reference sums float32); the JSON report with the
same keys in the same order and None in the same places, its floats within
1e-6 relative and mean HU within 1e-5; `run_pipeline`'s label files
byte-identical.
"""

import json

import numpy as np
import pytest
import torch
from scipy import ndimage

from boa_tpu.bca import pipeline as jpipe
from boa_tpu.bca import postprocess as jpp
from boa_tpu.bca import report as jrep
from boa_tpu.bca import tissues as jtis
from boa_tpu.bca import definitions as jdef
from boa_tpu.io.nifti import NiftiImage as JImage
from boa_tpu.ops import connected_components as jcc
from boa_tpu.tasks import class_maps as jcm
from boa_tpu.testing import anatomy as janat
from boa_tpu.weights.store import ModelStore as JStore
from boa_tpu_torch.bca import definitions as tdef
from boa_tpu_torch.bca import pipeline as tpipe
from boa_tpu_torch.bca import postprocess as tpp
from boa_tpu_torch.bca import report as trep
from boa_tpu_torch.bca import tissues as ttis
from boa_tpu_torch.io.nifti import NiftiImage as TImage
from boa_tpu_torch.ops import connected_components as tcc
from boa_tpu_torch.tasks import class_maps as tcm
from boa_tpu_torch.testing import anatomy as tanat
from boa_tpu_torch.utils.stages import HostWorker
from tests.test_bca import synthetic_study  # noqa: F401 (fixture)

BodyPart, BodyRegion = tdef.BodyPart, tdef.BodyRegion
VERTEBRAE = {"L3": (20, 26), "L1": (40, 41), "T7": (70, 79)}   # L1: one slice


def _blobs(shape, seed, n_labels, p=0.6, block=4):
    """Seeded blobby labels 1..n_labels-1 (0 background), block-upsampled,
    with a little speckle."""
    rng = np.random.default_rng(seed)
    coarse = rng.integers(1, n_labels, tuple(-(-n // block) for n in shape))
    coarse[rng.random(coarse.shape) > p] = 0
    seg = np.kron(coarse, np.ones((block,) * 3, np.int64))[:shape[0], :shape[1], :shape[2]]
    speckle = rng.random(shape) < 0.02
    seg[speckle] = rng.integers(0, n_labels, int(speckle.sum()))
    return np.ascontiguousarray(seg.astype(np.uint8))


def _close(got, want, path="", rtol=1e-6):
    """Same keys in the same order, None and bools in the same places,
    floats within rtol (mean_hu within 1e-5)."""
    if isinstance(want, dict):
        assert list(got) == list(want), path
        for k in want:
            _close(got[k], want[k], f"{path}/{k}", 1e-5 if k == "mean_hu" else rtol)
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{path}[{i}]", rtol)
    elif want is None or isinstance(want, (bool, str)):
        assert got == want and type(got) is type(want), (path, got, want)
    else:
        assert isinstance(got, (int, float)) and not np.isnan(got), (path, got)
        np.testing.assert_allclose(got, want, rtol=rtol, atol=0, err_msg=path)


# --- tables ------------------------------------------------------------------

def test_tables_match_reference():
    for fn in ("bca_body_regions", "bca_body_parts", "bca_tissues", "bca_hu_ranges",
               "bca_tissue_rules"):
        assert getattr(tcm, fn)() == getattr(jcm, fn)(), fn
    for enum_name in ("BodyRegion", "BodyPart", "Tissue"):
        assert [(e.name, int(e)) for e in getattr(tdef, enum_name)] == \
            [(e.name, int(e)) for e in getattr(jdef, enum_name)]
    assert tdef.HU_RANGES == jdef.HU_RANGES
    assert [(int(t), r, int(g)) for t, r, g in tdef.TISSUE_RULES] == \
        [(int(t), r, int(g)) for t, r, g in jdef.TISSUE_RULES]
    assert [int(t) for t in tdef.ADIPOSE_TISSUES] == [int(t) for t in jdef.ADIPOSE_TISSUES]


@pytest.mark.parametrize("fn", ["synth_ct", "fake_total_seg", "fake_regions_seg",
                                "fake_parts_seg", "part_292"])
def test_anatomy_paints_the_reference_volumes(fn):
    shape, spacing = (40, 36, 50), (9.0, 9.0, 12.0)
    if fn == "part_292":
        got, want = (m.fake_part_seg(shape, spacing, 292) for m in (tanat, janat))
    else:
        got, want = (getattr(m, fn)(shape, spacing) for m in (tanat, janat))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(want)) >= 2


# --- connected components and postprocessing -------------------------------

def test_component_sizes_and_keep_largest_match_reference():
    seg = _blobs((30, 26, 22), 3, 6, p=0.3)
    labels, n = tcc.label(seg == 2, connectivity=3)
    np.testing.assert_array_equal(tcc.component_sizes(labels, n),
                                  jcc.component_sizes(labels, n))
    lut = np.zeros(256, np.uint8)
    lut[[2, 3]] = 1
    got, want = seg.copy(), seg.copy()
    tcc.keep_largest_lut_inplace(got, lut)
    if not jcc.keep_largest_lut_inplace(want, lut):   # no native library
        jpp._filter_largest_unique_segment(want, lut[want].astype(bool))
    np.testing.assert_array_equal(got, want)
    assert (got == 255).any() and (got == 2).any()


@pytest.mark.parametrize("case", ["blobs_a", "blobs_b", "thin", "unique_segments",
                                  "global_largest"])
def test_region_postprocess_matches_reference(case):
    if case == "blobs_a":
        seg = _blobs((34, 30, 24), 11, 12)
    elif case == "blobs_b":
        seg = _blobs((28, 32, 20), 12, 12, p=0.35, block=3)
    elif case == "thin":   # sparse blobs: many components per label
        seg = _blobs((32, 32, 16), 13, 12, p=0.15, block=2)
    else:   # tests/test_bca.py's two cases
        seg = np.zeros((30, 30, 30), np.uint8)
        if case == "unique_segments":
            seg[5:15, 5:15, 5:15] = int(BodyRegion.PERICARDIUM)
            seg[20:23, 20:23, 20:23] = int(BodyRegion.PERICARDIUM)
        else:
            seg[2:20, 2:20, 2:20] = int(BodyRegion.MUSCLE)
            seg[25:28, 25:28, 25:28] = int(BodyRegion.BONE)
    got = tpp.postprocess_region_segmentation(seg)
    np.testing.assert_array_equal(got, jpp.postprocess_region_segmentation(seg))
    assert (got == 255).any() and got is not seg


def _parts_case(case):
    rng = np.random.default_rng(7)
    if case == "anatomy":
        return tanat.fake_parts_seg((48, 44, 30), (6.0, 6.0, 8.0)), 3000
    if case in ("edges", "edges_small"):
        # a slab clamped at both z faces, holes big and small, a corner blob,
        # a blob clamped at the high faces
        seg = np.zeros((40, 36, 24), np.uint8)
        seg[4:32, 6:30, :] = 1
        seg[10:14, 10:14, 4:20] = 0
        seg[20:22, 20:22, 8:10] = 0
        seg[0:3, 0:3, 0:3] = 2
        seg[33:40, 30:36, 10:24] = 3
        seg[16:24, 2:5, 5:15] = 5   # touches label 1 at the x-y ring
        return seg, (30 if case == "edges" else 3)
    if case == "torso_with_pockets":   # a hole at the volume's edge
        seg = np.zeros((50, 48, 30), np.uint8)
        seg[:, 4:44, 2:28] = int(BodyPart.TORSO)
        seg[0:6, 10:30, 5:25] = 0        # pocket on the clamped x face: size rule
        seg[20:30, 20:30, 10:20] = 0     # enclosed hole of 1000 voxels: filled
        seg[30:44, 10:40, 8:24] = 0      # enclosed hole of 6720 voxels: reopened
        seg[45:48, 45:48, 0:3] = int(BodyPart.HEAD)
        return seg, 3000
    sp = (rng.random((32, 30, 26)) < 0.35).astype(np.uint8)
    sp[sp > 0] = rng.integers(1, 4, size=int((sp > 0).sum())).astype(np.uint8)
    return sp, {"speckle_9": 9, "speckle_2": 2}[case]


@pytest.mark.parametrize("case", ["anatomy", "edges", "edges_small", "torso_with_pockets",
                                  "speckle_9", "speckle_2"])
def test_part_postprocess_matches_reference(case):
    """The port's fill and hole rules against the reference's (its native
    path where the library is built, else its cv2 path), on the pad-ring
    faces and on faces clamped at the volume's edge."""
    seg, threshold = _parts_case(case)
    got = tpp.remove_small_labeled_objects(seg.copy(), threshold)
    np.testing.assert_array_equal(got, jpp.remove_small_labeled_objects(seg.copy(), threshold))
    if threshold == 3000:
        np.testing.assert_array_equal(tpp.postprocess_part_segmentation(seg),
                                      jpp.postprocess_part_segmentation(seg))
    assert got.any()


def test_fill_slices_is_binary_fill_holes_per_slice():
    m = _blobs((26, 24, 12), 5, 2, p=0.7, block=2) > 0
    want = np.stack([ndimage.binary_fill_holes(m[:, :, k]) for k in range(m.shape[2])], 2)
    got = tpp.fill_slices(m)
    np.testing.assert_array_equal(got, want)
    assert (got & ~m).any()


# --- tissues ---------------------------------------------------------------

@pytest.mark.parametrize("median", [False, True])
def test_subclassify_tissues_matches_reference(median):
    rng = np.random.default_rng(4)
    shape = (24, 22, 12)
    ct = rng.integers(-400, 300, size=shape).astype(np.int16)
    ct[0, 0, :4] = (-32768, -1024, 3071, 32767)
    regions = rng.integers(0, 12, size=shape).astype(np.uint8)
    regions[5:7, 3:15, 2:9] = 255   # postprocess fragments
    want = jtis.subclassify_tissues(ct, regions, median_filtering=median)
    host, dev, regions_dev = ttis.subclassify_tissues(ct, regions, median_filtering=median,
                                                      device="cpu")
    np.testing.assert_array_equal(host, want)
    np.testing.assert_array_equal(dev.numpy(), want)
    np.testing.assert_array_equal(regions_dev.numpy(), regions)
    assert set(np.unique(want)) == set(range(8))


def test_subclassify_tissues_on_postprocessed_anatomy():
    shape, spacing = (48, 44, 40), (8.0, 8.0, 8.0)
    ct = tanat.synth_ct(shape, spacing)
    regions = tpp.postprocess_region_segmentation(_blobs(shape, 9, 12, p=0.5))
    assert (regions == 255).any()
    want = jtis.subclassify_tissues(ct, regions, median_filtering=True)
    got = ttis.subclassify_tissues(torch.from_numpy(ct), regions, median_filtering=True,
                                   device="cpu")[0]
    np.testing.assert_array_equal(got, want)


# --- report builder ----------------------------------------------------------

@pytest.fixture(scope="module")
def builders(synthetic_study):  # noqa: F811
    ct, parts, regions, tissues, spacing = synthetic_study
    parts = parts.copy()
    parts[5:12] = int(BodyPart.ARM_LEFT)   # limbs: the no-limb pass differs
    regions = regions.copy()
    regions[30:34, 28:30, 40:50] = 255
    ref = jrep.Builder(ct, parts, regions, tissues, spacing)
    got = trep.Builder(ct, parts, regions, tissues, spacing, device="cpu")
    bp = jrep.AggregatableBodyPart.from_body_regions(regions, spacing[2])
    ref.examined_body_part = bp
    got.examined_body_part = trep.AggregatableBodyPart(int(bp))
    return ref, got, synthetic_study


def test_builder_slicewise_pass_matches_reference(builders):
    ref, got, (_, _, _, tissues, _) = builders
    np.testing.assert_array_equal(got._counts, ref._counts)
    np.testing.assert_array_equal(got._counts_nl, ref._counts_nl)
    assert (got._counts_nl != got._counts).any()
    np.testing.assert_allclose(got._husums, ref._husums, rtol=1e-6, atol=0)
    np.testing.assert_allclose(got._husums_nl, ref._husums_nl, rtol=1e-6, atol=0)
    for table, df in ((got.slicewise_measurements(), ref.slicewise_measurements()),
                      (got.slicewise_measurements_no_limbs(),
                       ref.slicewise_measurements_no_limbs())):
        assert list(table) == list(df.columns)
        for col in df.columns:
            np.testing.assert_array_equal(table[col], df[col].to_numpy(), err_msg=col)
    # the reference's host pass has a column per id up to 255; the port's
    # columns stop at 16, and the 255 fragments count in none
    zc, zc_ref = got.region_z_counts(), ref.region_z_counts()
    assert zc.shape == (tissues.shape[2], 16) and not zc[:, 12:].any()
    np.testing.assert_array_equal(zc, zc_ref[:, :16])
    np.testing.assert_array_equal(got.axial_ct_slices([0, 7, 50], 2),
                                  ref.axial_ct_slices([0, 7, 50], 2))


def test_body_part_detection_matches_reference(builders):
    ref, got, (_, _, regions, _, spacing) = builders
    for kw in ({}, {"min_abdomen_length": 300}, {"min_neck_length": 101},
               {"min_thorax_length": 230}):
        want = jrep.AggregatableBodyPart.from_body_regions(regions, spacing[2], **kw)
        assert int(trep.AggregatableBodyPart.from_body_regions(
            regions, spacing[2], **kw)) == int(want), kw
        assert int(trep.AggregatableBodyPart.from_body_regions(
            regions, spacing[2], z_counts=got.region_z_counts(), **kw)) == int(want), kw


def test_groups_and_findings_match_reference(builders):
    ref, got, _ = builders
    assert got.aggregation_groups(VERTEBRAE) == ref.aggregation_groups(VERTEBRAE)
    assert len(got.aggregation_groups(None)) == 6
    assert got.generate_secondary_findings() == ref.generate_secondary_findings()
    assert len(got.generate_secondary_findings()) == 4


@pytest.mark.parametrize("implants", [0, 1, 2, 3])
def test_breast_implant_findings_match_reference(implants):
    rng = np.random.default_rng(implants)
    regions = np.zeros((60, 40, 24), np.uint8)
    speckle = rng.random(regions.shape) < 0.02
    regions[speckle] = int(BodyRegion.BREAST_IMPLANT)
    for box in [(slice(4, 20), slice(10, 30), slice(4, 14)),
                (slice(40, 56), slice(10, 30), slice(4, 14)),
                (slice(25, 37), slice(0, 8), slice(17, 24))][:implants]:
        regions[box] = int(BodyRegion.BREAST_IMPLANT)
    regions[:, 35:, :] = int(BodyRegion.PERICARDIUM)
    ct = np.zeros(regions.shape, np.int16)
    parts = np.full(regions.shape, int(BodyPart.TORSO), np.uint8)
    tissues = np.zeros(regions.shape, np.uint8)
    ref = jrep.Builder(ct, parts, regions, tissues, (2.0, 2.0, 5.0))
    got = trep.Builder(ct, parts, regions, tissues, (2.0, 2.0, 5.0), device="cpu")
    ref.examined_body_part = jrep.AggregatableBodyPart.THORAX
    got.examined_body_part = trep.AggregatableBodyPart.THORAX
    want = ref.generate_secondary_findings()
    assert got.generate_secondary_findings() == want
    assert (implants in (1, 2)) == any("implant" in f for f in want)


@pytest.mark.parametrize("total_measurements", [False, True])
def test_prepare_and_json_match_reference(builders, total_measurements):
    ref, got, _ = builders
    tm = None
    if total_measurements:
        tm = {"segmentations": {"total": {
            "liver": {"present": True, "volume_ml": 1500.5, "25th_percentile_hu": 40.0,
                      "75th_percentile_hu": 70.0, "mean_hu": 55.0},
            "spleen": {"present": False, "volume_ml": 0.0},
            "vertebrae_L3": {"present": True, "volume_ml": 30.0, "mean_hu": 400.0}}}}
    want = ref.prepare(VERTEBRAE, total_measurements=tm)
    prep = got.prepare(VERTEBRAE, total_measurements=tm)
    assert list(prep) == list(want)
    for ax in (1, 0):
        np.testing.assert_array_equal(prep["tissue_density"][ax], want["tissue_density"][ax])
    for k in ("check_idxs", "ct_slices", "tissue_slices"):
        np.testing.assert_array_equal(prep["equidistant_slice_check"][k],
                                      want["equidistant_slice_check"][k])
    assert prep["equidistant_slice_check"]["mid_idxs"] == \
        want["equidistant_slice_check"]["mid_idxs"]
    assert prep["other_findings"] == want["other_findings"]
    if tm is None:
        assert prep["measurements_total"] is want["measurements_total"] is None
    else:
        table = want["measurements_total"].replace({np.nan: None})
        assert prep["measurements_total"] == table.to_dict("index")
        assert list(prep["measurements_total"]["Liver"]) == list(table.columns)
    for (name, rng_, _, s, s_nl), (wname, wrng, _, ws, ws_nl) in zip(
            prep["aggregated_measurements"], want["aggregated_measurements"]):
        assert (name, rng_) == (wname, wrng)
        _close(s, ws.to_dict())
        _close(s_nl, ws_nl.to_dict())
    data = got.create_json(**prep)
    ref_data = json.loads(json.dumps(ref.create_json(**want)))
    _close(json.loads(json.dumps(data)), ref_data)
    # the one-slice vertebra: std None on both sides, the rest numbers
    l1 = data["aggregated"]["l1"]["measurements"]["muscle"]
    assert l1["std"] is None and l1["mean"] is not None
    assert data["aggregated"]["pericardium"]["measurements"]["bone"]["mean_hu"] is None
    assert json.dumps(data) and data["body_parts"] == ref_data["body_parts"]


def test_vertebrae_info_matches_reference(monkeypatch):
    cm = jcm.get_class_map("total")
    seg = np.random.default_rng(2).integers(0, 118, (24, 22, 37)).astype(np.uint8)
    for bp in (1, 2, 3, 7):
        want = jrep.create_vertebrae_info(seg, jrep.AggregatableBodyPart(bp), cm)
        assert trep.create_vertebrae_info(seg, trep.AggregatableBodyPart(bp), cm) == want
    monkeypatch.setattr(jrep.native, "get_lib", lambda: None)
    assert trep.create_vertebrae_info(seg, trep.AggregatableBodyPart(7), cm) == \
        jrep.create_vertebrae_info(seg, jrep.AggregatableBodyPart(7), cm)


def _pages(pdf: bytes) -> int:
    return pdf.count(b"/Type /Page") - pdf.count(b"/Type /Pages")


def test_pdf_waits_for_m9(builders, anatomy_study, tmp_path):
    """The PDF report, which raised until its renderer was ported (ROADMAP
    M9 (i)): `create_pdf` gives 3 pages and one per aggregation window
    (tests/test_torch_render.py holds them against the reference's), and
    `run_pipeline`'s default `save_pdf=True` writes `report.pdf` (with a
    HostWorker: rendered there, written on return), its time in
    `report_pdf`."""
    _, got, _ = builders
    pdf = got.create_pdf(**got.prepare(None))
    assert pdf.startswith(b"%PDF-1.4") and \
        _pages(pdf) == 3 + len(got.generate_aggregated_measurements(None))
    ct, total, affine, _, _ = anatomy_study
    for worker in (False, True):
        spans: dict = {}
        out = tmp_path / str(worker)
        with HostWorker() as w:
            data = tpipe.run_pipeline(TImage(data=ct, affine=affine), out,
                                      fake_predict=tanat.fake_predict_factory(),
                                      total_seg=total, worker=w if worker else None,
                                      device="cpu", spans=spans)
            report = (out / "report.pdf").read_bytes()
        assert _pages(report) == 3 + len(data["aggregated"]) and "report_pdf" in spans


def test_entry_points_default_to_cuda(builders, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, _, (ct, parts, regions, tissues, spacing) = builders
    with pytest.raises(RuntimeError, match="CUDA"):
        ttis.subclassify_tissues(ct, regions)
    with pytest.raises(RuntimeError, match="CUDA"):
        trep.Builder(ct, parts, regions, tissues, spacing)


# --- the pipeline through the fake hook -------------------------------------

@pytest.fixture(scope="module")
def anatomy_study(tmp_path_factory):
    """The phantom at 600 mm (abdomen and vertebrae) and the reference's run."""
    shape, spacing = (48, 44, 120), (8.0, 8.0, 5.0)
    ct = janat.synth_ct(shape, spacing)
    total = janat.fake_total_seg(shape, spacing)
    affine = np.diag([-spacing[0], -spacing[1], spacing[2], 1.0])
    ref = tmp_path_factory.mktemp("bca_ref")
    want = jpipe.run_pipeline(JImage(data=ct, affine=affine), ref,
                              store=JStore("/nonexistent"), save_pdf=False,
                              fake_predict=janat.fake_predict_factory(), total_seg=total,
                              median_filtering=True)
    return ct, total, affine, ref, want


@pytest.mark.parametrize("worker", [False, True])
def test_run_pipeline_matches_reference(anatomy_study, tmp_path, worker):
    ct, total, affine, ref, want = anatomy_study
    spans: dict = {}
    images: dict = {}
    kw = dict(save_pdf=False, fake_predict=tanat.fake_predict_factory(), total_seg=total,
              median_filtering=True, device="cpu", spans=spans, images_out=images)
    if worker:
        with HostWorker() as w:
            got = tpipe.run_pipeline(TImage(data=ct, affine=affine), tmp_path, worker=w, **kw)
    else:
        got = tpipe.run_pipeline(TImage(data=ct, affine=affine), tmp_path, **kw)
    names = sorted(p.name for p in ref.iterdir())
    assert sorted(p.name for p in tmp_path.iterdir()) == names == [
        "bca-measurements.json", "body_parts.nii.gz", "body_regions.nii.gz",
        "tissues.nii.gz", "vertebrae.json"]
    for name in names[1:4]:
        assert (tmp_path / name).read_bytes() == (ref / name).read_bytes(), name
    _close(got, want)
    _close(json.loads((tmp_path / "bca-measurements.json").read_text()),
           json.loads((ref / "bca-measurements.json").read_text()))
    assert json.loads((tmp_path / "vertebrae.json").read_text()) == \
        json.loads((ref / "vertebrae.json").read_text())
    assert got["body_parts"]["abdomen"] and len(got["aggregated"]) > 3
    assert set(images) == {"body_parts", "body_regions", "tissues"}
    assert {"predict_543", "predict_542", "postprocess_body_parts",
            "postprocess_body_regions", "tissues", "tissues.median", "builder",
            "builder.slicewise", "prepare", "save", "save_wait"} <= set(spans)


def test_run_pipeline_reuses_its_files(anatomy_study, tmp_path):
    """recompute=False loads both models' files instead of predicting."""
    ct, total, affine, ref, want = anatomy_study
    kw = dict(save_pdf=False, total_seg=total, median_filtering=True, device="cpu")
    tpipe.run_pipeline(TImage(data=ct, affine=affine), tmp_path,
                       fake_predict=tanat.fake_predict_factory(), **kw)

    def no_call(*a):
        raise AssertionError("a computed model ran again")

    got = tpipe.run_pipeline(TImage(data=ct, affine=affine), tmp_path, recompute=False,
                             fake_predict=no_call, **kw)
    _close(got, want)
