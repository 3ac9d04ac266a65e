"""The port's TotalSegmentator tools (boa_tpu_torch/tools/{evans_index,
crop_to_body,get_modality,get_phase}.py) against the reference's
(boa_tpu/tools/), on the CPU, on volumes made from a seed with numpy.

The commands run through a geometric fake-inference hook in both packages
(the reference's `main`s take none, so its `predict_image` is wrapped to
pass it). Bars: every result dict, JSON file and sidecar equal, cropped
images byte-identical; the Evans index after an atlas registration within
0.02 of the reference's, its rotation within 0.5 degrees.
"""

import json
import pickle

import numpy as np
import pytest
import torch
from scipy import ndimage as ndi

import boa_tpu.inference.pipeline as jpipe
from boa_tpu.io import nifti as jn
from boa_tpu.tools import crop_to_body as jcrop
from boa_tpu.tools import evans_index as jev
from boa_tpu.tools import get_modality as jmod
from boa_tpu.tools import get_phase as jphase
from boa_tpu_torch.io import nifti as tn
from boa_tpu_torch.testing import anatomy as tanat
from boa_tpu_torch.tools import crop_to_body as tcrop
from boa_tpu_torch.tools import evans_index as tev
from boa_tpu_torch.tools import get_modality as tmod
from boa_tpu_torch.tools import get_phase as tphase


@pytest.fixture(autouse=True)
def _env(tmp_path, monkeypatch):
    """Each test's own config and weight roots; torch on two threads (the
    registration's small steps run no faster on more, and the suite's
    workers share the cores)."""
    monkeypatch.setenv("BOA_TPU_CONFIG_DIR", str(tmp_path / "cfg"))
    monkeypatch.setenv("BOA_WEIGHTS_PATH", str(tmp_path / "weights"))
    for var in ("BOA_MODALITY_MODEL", "BOA_PHASE_MODEL"):
        monkeypatch.delenv(var, raising=False)
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _hook(vol, spacing, task_id):
    """Geometric labels on the model grid, valid for each task's map:
    ellipsoidal shells about the centre (in mm, so every grid agrees)."""
    shape = vol.shape
    axes = [(np.arange(n) - (n - 1) / 2) * s for n, s in zip(shape, spacing)]
    ext = [max(n * s / 2, 1.0) for n, s in zip(shape, spacing)]
    x, y, z = np.meshgrid(*axes, indexing="ij")
    d = np.sqrt((x / ext[0]) ** 2 + (y / ext[1]) ** 2 + (z / ext[2]) ** 2)
    seg = np.zeros(shape, np.uint8)
    if task_id == 552:           # ventricle_parts: frontal horns 1 and 6
        horn = (np.abs(y / ext[1] - 0.2) < 0.1) & (np.abs(z / ext[2]) < 0.3)
        seg[horn & (x < 0) & (x / ext[0] > -0.25)] = 1
        seg[horn & (x > 0) & (x / ext[0] < 0.25)] = 6
    elif task_id == 297:         # total fast: brain in skull, a liver
        seg[d < 0.7] = 90
        seg[(d >= 0.7) & (d < 0.85)] = 91
        seg[(x / ext[0] > 0.3) & (d < 0.5)] = 5
    elif task_id == 776:         # headneck: the four neck vessels
        for k, cx in enumerate((-0.4, -0.2, 0.2, 0.4)):
            seg[(np.abs(x / ext[0] - cx) < 0.06) & (np.abs(y / ext[1]) < 0.06)] = 9 + k
    elif task_id == 300:         # body fast: trunc inside extremities
        seg[d < 0.6] = 1
        seg[(d >= 0.6) & (d < 0.8)] = 2
    elif task_id == 852:         # total_mr fast: brain, cord, iliopsoas
        seg[d < 0.4] = 50
        seg[(np.abs(x) < 4) & (np.abs(y) < 4)] = 21
        seg[(x / ext[0] > 0.45) & (d < 0.7)] = 48
    return seg


_hook.wants_volume = False


def _torso_hook(vol, spacing, task_id):
    """`_hook` without the brain."""
    seg = _hook(vol, spacing, task_id)
    if task_id == 297:
        seg[seg == 90] = 0
    return seg


_torso_hook.wants_volume = False


def _hook_reference(monkeypatch, hook=_hook):
    """The reference's commands take no hook: wrap its predict_image so
    every call made without one gets `hook`."""
    orig = jpipe.predict_image

    def hooked(*args, **kw):
        if kw.get("fake_predict") is None:
            kw["fake_predict"] = hook
        return orig(*args, **kw)

    monkeypatch.setattr(jpipe, "predict_image", hooked)


def _ct(tmp_path, shape=(48, 40, 24), spacing=(4.0, 4.0, 6.0), name="ct.nii.gz"):
    data = tanat.synth_ct(shape=shape, spacing=spacing)
    tn.save(tn.NiftiImage(data=data, affine=np.diag([*spacing, 1.0])), tmp_path / name)
    return tmp_path / name


# --------------------------------------------------------------------------- evans


def _evans_cases(tmp_path):
    """tests/test_tools.py's Evans cases: (args, kwargs) of evans_index."""
    vent = np.zeros((40, 40, 10), np.uint8)
    vent[12:19, 20, 5] = 1
    vent[21:28, 20, 5] = 2
    brain = np.zeros((40, 40, 10), bool)
    brain[5:35, 10:30, :] = True
    lm3 = {1: "frontal_horn_left", 2: "frontal_horn_right", 3: "occipital_horn_left"}
    yy, xx = np.mgrid[0:80, 0:80]
    ell = ((xx - 40) ** 2 / 24 ** 2 + (yy - 40) ** 2 / 34 ** 2) < 1.0
    brain0 = np.repeat(ell.T[:, :, None], 8, axis=2)
    vent0 = np.zeros((80, 80, 8), np.uint8)
    vent0[28:36, 52, 4] = 1
    vent0[44:52, 52, 4] = 2
    lm2 = {1: "frontal_horn_left", 2: "frontal_horn_right"}
    brain_r = ndi.rotate(brain0.astype(np.uint8), 14.0, axes=(1, 0), reshape=False,
                         order=0) > 0
    vent_r = ndi.rotate(vent0, 14.0, axes=(1, 0), reshape=False, order=0)
    shape = (64, 64, 12)
    brain_s = np.zeros(shape, bool)
    brain_s[16:48, 16:48, 2:10] = True
    skull = np.zeros(shape, bool)
    skull[12:52, 12:52, 1:11] = True
    skull[13:51, 13:51, 1:11] = False
    vent_s = np.zeros(shape, np.uint8)
    vent_s[28:36, 28:36, 4:8] = 1
    return {
        "basic": ((vent, lm3, brain, (1.0, 1.0, 5.0)), {}),
        "empty": ((np.zeros((5, 5, 5), np.uint8), {}, np.zeros((5, 5, 5), bool), (1, 1, 1)),
                  {}),
        "aligned": ((vent0, lm2, brain0, (1.0, 1.0, 5.0)), {}),
        "rotated": ((vent_r, lm2, brain_r, (1.0, 1.0, 5.0)), {}),
        "skull": ((vent_s, {1: "frontal_horn_left"}, brain_s, (1.0, 1.0, 1.0)),
                  {"skull_mask": skull}),
        "no_skull": ((vent_s, {1: "frontal_horn_left"}, brain_s, (1.0, 1.0, 1.0)), {}),
        "anisotropic": ((vent_r, lm2, brain_r, (1.0, 1.2, 5.0)), {}),
    }


@pytest.mark.parametrize("case", ["basic", "empty", "aligned", "rotated", "skull", "no_skull",
                                  "anisotropic"])
def test_evans_index_matches_reference(tmp_path, case):
    args, kw = _evans_cases(tmp_path)[case]
    got = tev.evans_index(*args, **kw)
    assert got == jev.evans_index(*args, **kw)
    if case == "basic":
        assert got["evans_index"] == pytest.approx(15 / 29, abs=1e-3)


def test_evans_helpers_match_reference():
    rng = np.random.default_rng(3)
    m = ndi.binary_opening(rng.random((30, 20, 6)) < 0.4)
    assert tev.max_diameter_x(m) == jev.max_diameter_x(m)
    blob = np.zeros((80, 80, 4), bool)
    yy, xx = np.mgrid[0:80, 0:80]
    blob[(((xx - 70) ** 2 + (yy - 70) ** 2) < 15 ** 2).T] = True
    for a, b in zip(tev._rotate_masks_inplane(30.0, blob, blob[::-1]),
                    jev._rotate_masks_inplane(30.0, blob, blob[::-1])):
        np.testing.assert_array_equal(a, b)
    ell = ndi.rotate((((xx - 40) / 24.0) ** 2 + ((yy - 40) / 34.0) ** 2 < 1).T.astype(np.uint8),
                     -11.0, reshape=False, order=0)[:, :, None].repeat(3, 2) > 0
    assert tev.inplane_rotation_deg(ell) == jev.inplane_rotation_deg(ell)
    assert tev.inplane_rotation_deg(ell, (1.0, 1.3)) == jev.inplane_rotation_deg(ell, (1.0, 1.3))
    skull = np.zeros((30, 30, 8), bool)
    skull[3:27, 3:27, :] = True
    skull[5:25, 5:25, :] = False
    brain = np.zeros((30, 30, 8), bool)
    brain[8:22, 8:22, 2:6] = True
    np.testing.assert_array_equal(tev.inner_skull_cavity(brain, skull),
                                  jev.inner_skull_cavity(brain, skull))


def test_evans_plot_is_drawn(tmp_path):
    """The overview PNG on the port's canvas: a gray slice, the two green
    diameters and red end marks under the title."""
    from PIL import Image

    args, kw = _evans_cases(tmp_path)["basic"]
    res = tev.evans_index(*args, plot_file=tmp_path / "evans.png", **kw)
    img = np.asarray(Image.open(tmp_path / "evans.png").convert("RGB")).astype(int)
    assert res["success"] and img.shape[1] == 600
    green = (img[..., 1] > 100) & (img[..., 0] < 50) & (img[..., 2] < 50)
    red = (img[..., 0] > 200) & (img[..., 1] < 50) & (img[..., 2] < 50)
    assert green.sum() > 500 and red.sum() > 50
    assert (img[:60] == 0).all(axis=-1).any()   # the title's black text


def test_evans_atlas_registration_matches_reference():
    """tests/test_registration.py's rotation-invariance case (the atlas at
    2 mm, turned 10 degrees) through both packages' registration."""
    atlas = ndi.zoom(np.asarray(tn.load(tev._ATLAS_PATH).data, np.float32), 0.5, order=1)
    vent = np.zeros(atlas.shape, np.uint8)
    cx, cy, cz = (s // 2 for s in atlas.shape)
    vent[cx - 12:cx - 3, cy + 10, cz] = 1
    vent[cx + 3:cx + 12, cy + 10, cz] = 2
    label_map = {1: "frontal_horn_left", 2: "frontal_horn_right"}
    ct = ndi.rotate(atlas, 10.0, axes=(1, 0), reshape=False, order=1)
    vent = ndi.rotate(vent, 10.0, axes=(1, 0), reshape=False, order=0)
    brain = ndi.rotate((atlas > 50.0).astype(np.uint8), 10.0, axes=(1, 0), reshape=False,
                       order=0) > 0
    kw = dict(ct=ct, atlas_data=atlas, atlas_spacing=2.0, registration_steps=60)
    got = tev.evans_index(vent, label_map, brain, (2.0, 2.0, 2.0), device="cpu", **kw)
    want = jev.evans_index(vent, label_map, brain, (2.0, 2.0, 2.0), **kw)
    assert got["success"] and want["success"]
    g, w = got.pop("atlas_registration"), want.pop("atlas_registration")
    assert abs(abs(g["rotation_deg"][2]) - 10.0) < 2.5
    assert np.abs(np.subtract(g["rotation_deg"], w["rotation_deg"])).max() <= 0.5
    assert abs(g["ncc"] - w["ncc"]) < 1e-3
    assert got["evans_index"] == pytest.approx(want["evans_index"], abs=0.02)
    assert got["ventricle_volume_ml"] == want["ventricle_volume_ml"]


def test_evans_main_matches_reference(tmp_path, monkeypatch, capsys):
    """The command through the hook in both packages: the same JSON. The
    reference looks the horns up as "frontal_horn_*", while the
    ventricle_parts map names them "ventricle_frontal_horn_*", so the
    command reports an empty segmentation in both (ROADMAP Queue 3)."""
    _hook_reference(monkeypatch)
    ct = _ct(tmp_path, (24, 20, 12), (4.0, 4.0, 6.0))
    tev.main(["-i", str(ct), "-o", str(tmp_path / "t.json"), "-p", str(tmp_path / "t.png"),
              "-d", "cpu"], fake_predict=_hook)
    jev.main(["-i", str(ct), "-o", str(tmp_path / "j.json"), "-p", str(tmp_path / "j.png")])
    got = json.loads((tmp_path / "t.json").read_text())
    assert got == json.loads((tmp_path / "j.json").read_text())
    assert got == {"success": False, "reason": "empty ventricle or brain segmentation"}
    assert not (tmp_path / "t.png").exists() and not (tmp_path / "j.png").exists()


# --------------------------------------------------------------------------- crop_to_body


@pytest.mark.parametrize("only_trunc", [False, True])
def test_crop_to_body_matches_reference(tmp_path, monkeypatch, only_trunc):
    """The library call and the command (cropped file and `_bbox.json`
    sidecar) through the hook in both packages."""
    _hook_reference(monkeypatch)
    ct = _ct(tmp_path)
    img_t, img_j = tn.load(ct), jn.load(ct)
    got, bbox = tcrop.crop_to_body(img_t, only_trunc=only_trunc, fake_predict=_hook,
                                   device="cpu")
    want, jbbox = jcrop.crop_to_body(img_j, only_trunc=only_trunc, fake_predict=_hook)
    assert bbox == jbbox and bbox != [[0, n] for n in img_t.shape]
    np.testing.assert_array_equal(np.asarray(got.data), np.asarray(want.data))
    np.testing.assert_array_equal(got.affine, want.affine)
    flags = ["-t"] if only_trunc else []
    for d in ("t", "j"):   # the gzip header holds the file name
        (tmp_path / d).mkdir()
    tcrop.main(["-i", str(ct), "-o", str(tmp_path / "t" / "c.nii.gz"), "-d", "cpu", "-q",
                *flags], fake_predict=_hook)
    jcrop.main(["-i", str(ct), "-o", str(tmp_path / "j" / "c.nii.gz"), "-q", *flags])
    assert (tmp_path / "t" / "c.nii.gz").read_bytes() == (tmp_path / "j" / "c.nii.gz").read_bytes()
    side = json.loads((tmp_path / "t" / "c_bbox.json").read_text())
    assert side == json.loads((tmp_path / "j" / "c_bbox.json").read_text())
    assert side == {"bbox": bbox, "original_shape": list(img_t.shape)}


# --------------------------------------------------------------------------- modality


def _volumes():
    rng = np.random.default_rng(8)
    ct = rng.normal(40, 300, (20, 20, 20)).astype(np.float32)
    ct[0:5] = -1000
    mr = np.abs(rng.normal(400, 150, (20, 20, 20))).astype(np.float32)
    flat = np.full((6, 6, 6), 12.5, np.float32)
    return {"ct": ct, "mr": mr, "flat": flat}


def test_get_modality_matches_reference(tmp_path, monkeypatch):
    """The vendored folds, a BOA_MODALITY_MODEL pickle and a missing model
    path, on CT-like, MR-like and flat volumes."""
    from sklearn.tree import DecisionTreeClassifier

    vols = _volumes()
    for name, vol in vols.items():
        got = tmod.get_modality(vol)
        assert got == jmod.get_modality(vol), name
        assert tmod.get_features(vol) == jmod.get_features(vol)
    assert tmod.get_modality(vols["ct"])["modality"] == "ct"
    assert tmod.get_modality(vols["mr"])["modality"] == "mr"
    x = np.array([tmod.get_features(v) for v in vols.values()] * 4)
    clf = DecisionTreeClassifier(random_state=0).fit(x, [0, 1, 0] * 4)
    with open(tmp_path / "m.pkl", "wb") as f:
        pickle.dump({"fold0": clf, "fold1": clf}, f)
    monkeypatch.setenv("BOA_MODALITY_MODEL", str(tmp_path / "m.pkl"))
    for vol in vols.values():
        assert tmod.get_modality(vol) == jmod.get_modality(vol)
    monkeypatch.setenv("BOA_MODALITY_MODEL", str(tmp_path / "missing.pkl"))
    for mod in (tmod, jmod):
        with pytest.raises(FileNotFoundError):
            mod.get_modality(vols["ct"])


def test_get_modality_from_rois_matches_reference(tmp_path):
    """-n: the fast total_mr model through the hook, normalized median
    intensities of the 16 organs, scored by the normalized folds."""
    ct = _ct(tmp_path)
    got = tmod.get_modality_from_rois(tn.load(ct), _hook, device="cpu")
    want = jmod.get_modality_from_rois(jn.load(ct), _hook)
    assert got == want and len(got["features"]) == 16
    assert sum(f != 0 for f in got["features"]) >= 2


@pytest.mark.parametrize("normalized", [False, True])
def test_get_modality_main_matches_reference(tmp_path, monkeypatch, normalized):
    _hook_reference(monkeypatch)
    ct = _ct(tmp_path)
    flag = ["-n"] if normalized else []
    tmod.main(["-i", str(ct), "-o", str(tmp_path / "t.json"), "-d", "cpu", *flag],
              fake_predict=_hook)
    if normalized:   # the reference's -n calls get_modality_from_rois without a hook
        monkeypatch.setattr(jmod, "get_modality_from_rois",
                            lambda img, fake_predict=None, _f=jmod.get_modality_from_rois:
                            _f(img, _hook))
    jmod.main(["-i", str(ct), "-o", str(tmp_path / "j.json"), *flag])
    assert json.loads((tmp_path / "t.json").read_text()) == \
        json.loads((tmp_path / "j.json").read_text())


# --------------------------------------------------------------------------- get_phase


@pytest.mark.parametrize("head", [False, True])
def test_get_phase_main_matches_reference(tmp_path, monkeypatch, head):
    """The command through the hook in both packages: with a brain over 100
    (mm^3) headneck_bones_vessels runs for the four vessel features; without
    one it does not."""
    hook = _hook if head else _torso_hook
    _hook_reference(monkeypatch, hook)
    ct = _ct(tmp_path)
    calls = []
    orig = jpipe.predict_image

    def counting(img, task, *a, **kw):
        calls.append(task)
        return orig(img, task, *a, **kw)

    monkeypatch.setattr(jpipe, "predict_image", counting)
    tphase.main(["-i", str(ct), "-o", str(tmp_path / "t.json"), "-d", "cpu"], fake_predict=hook)
    jphase.main(["-i", str(ct), "-o", str(tmp_path / "j.json")])
    got = json.loads((tmp_path / "t.json").read_text())
    assert got == json.loads((tmp_path / "j.json").read_text())
    assert ("headneck_bones_vessels" in calls) == head
    assert set(got) == {"pi_time", "pi_time_std", "phase", "probability", "pi_time_min",
                        "pi_time_max"}


# --------------------------------------------------------------------------- device rule


@pytest.mark.parametrize("tool", [tev, tcrop, tmod, tphase])
def test_commands_default_to_the_card(tmp_path, tool):
    """Without -d every command asks for the card and raises where there is
    none; an unknown device name raises ValueError."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    ct = _ct(tmp_path, (8, 8, 4), (3.0, 3.0, 3.0))
    args = ["-i", str(ct), "-o", str(tmp_path / "out.nii.gz")]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tool.main(args, fake_predict=_hook)
    with pytest.raises(ValueError, match="unsupported device"):
        tool.main([*args, "-d", "tpu"], fake_predict=_hook)
