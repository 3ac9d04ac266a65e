"""The port's segmentation preview (boa_tpu_torch/compute/preview.py) against
the reference's (boa_tpu/compute/preview.py), on the CPU.

Bars: the per-group fronts, label indices and label lists equal to the
integer (the port's pass on a CPU tensor, the reference's XLA pass and its
host version), as tests/test_pipeline.py requires of the reference; the
shaded overlays within rtol 1e-5, atol 1e-6; the montage 1760 x 660 with
more than 50 pixels of saturation above 0.15 in each of the five panels
(tests/test_bca.py's bar), its PNG decoding to the canvas drawn, and the
same bytes from the device fronts and from the host version's.
"""

import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from boa_tpu.compute import preview as jprev
from boa_tpu.tasks.class_maps import get_class_map
from boa_tpu.testing import anatomy as janat
from boa_tpu_torch.compute import preview as tprev
from boa_tpu_torch.io.nifti import NiftiImage
from boa_tpu_torch.render import raster
from boa_tpu_torch.testing import anatomy as tanat
from boa_tpu_torch.utils.stages import HostWorker

CMAP = get_class_map("total")
INV = {v: k for k, v in CMAP.items()}
N_LABELS = max(CMAP) + 1
SHAPE, SPACING = (96, 96, 60), (4.0, 4.0, 6.0)


@pytest.fixture(scope="module")
def phantom():
    seg = tanat.fake_total_seg(SHAPE, SPACING)
    np.testing.assert_array_equal(seg, janat.fake_total_seg(SHAPE, SPACING))
    return tanat.synth_ct(SHAPE, SPACING), seg


def _same_fronts(got, want, host=None):
    assert list(got) == list(want) == list(tprev.ROI_GROUPS)
    for group in want:
        if want[group] is None:
            assert got[group] is None and (host is None or host[group] is None)
            continue
        (fg, wg, lg), (fw, ww, lw) = got[group], want[group]
        assert fg.dtype == fw.dtype == np.float32 and wg.dtype == ww.dtype == np.uint8
        assert list(lg) == list(lw)
        np.testing.assert_array_equal(fg, fw, err_msg=group)
        np.testing.assert_array_equal(wg, ww, err_msg=group)
        if host is not None:
            fh, wh, lh = host[group]
            assert lh == list(lg)
            np.testing.assert_array_equal(fg, fh, err_msg=group)
            np.testing.assert_array_equal(wg, wh, err_msg=group)


@pytest.mark.parametrize("case", ["phantom", "random", "no_ribs_in_map"])
def test_fronts_match_reference(phantom, case):
    """The fronts of the port's pass on a CPU tensor against the reference's
    pass on a jnp array and against the host version; where no ray hits,
    the host's argmin and the pass's encoding both read index 0."""
    seg = phantom[1]
    inv = INV
    if case == "random":
        seg = np.random.default_rng(3).integers(0, N_LABELS, (40, 36, 30)).astype(np.uint8)
    elif case == "no_ribs_in_map":   # a group with none of its labels: None
        inv = {n: i for n, i in INV.items() if n not in tprev.ROI_GROUPS["ribs"]}
    got = tprev._group_fronts_device(torch.from_numpy(seg), inv, N_LABELS)
    want = jprev._group_fronts_device(jnp.asarray(seg), inv, N_LABELS)
    host = tprev._group_fronts_from_depths(tprev._label_depths(seg, N_LABELS), inv)
    _same_fronts(got, want, host)
    _same_fronts(host, jprev._group_fronts_from_depths(jprev._label_depths(seg, N_LABELS), inv))
    if case == "phantom":   # the phantom fills every group
        assert all(np.isfinite(got[g][0]).any() for g in tprev.ROI_GROUPS)
    assert (got["ribs"] is None) == (case == "no_ribs_in_map")


def test_shade_group_matches_reference(phantom):
    fronts = jprev._group_fronts_from_depths(jprev._label_depths(phantom[1], N_LABELS), INV)
    for group, (front, which, labels) in fronts.items():
        colors = np.random.default_rng(len(labels)).random((len(labels), 3)).astype(np.float32)
        for aspect in (1.5, 0.5):
            want = jprev._shade_group(front, which, colors, aspect)
            got = tprev._shade_group(front, which, colors, aspect)
            assert got.shape == want.shape == (SHAPE[2], SHAPE[1], 4)
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6, err_msg=group)
    empty = np.full((5, 4), np.inf, np.float32)
    assert not tprev._shade_group(empty, np.zeros((5, 4), np.uint8), colors, 1.0).any()


def _montage(monkeypatch, run) -> list[np.ndarray]:
    """The montages `run()` draws, as the canvas holds them when saved."""
    drawn, save = [], raster.Canvas.save_png

    def keep(self, path):
        drawn.append(self.to_uint8())
        save(self, path)

    monkeypatch.setattr(raster.Canvas, "save_png", keep)
    run()
    return drawn


@pytest.mark.parametrize("worker", [False, True])
def test_generate_preview_montage(phantom, tmp_path, monkeypatch, worker):
    """`generate_preview` on the CPU (with a HostWorker: the render on its
    thread, the Future returned): the reference's size, a coloured overlay
    in every panel, and the PNG holds what the canvas drew."""
    ct, seg = phantom
    aff = np.diag([*SPACING, 1.0])
    out = tmp_path / "p.png"
    spans: dict = {}

    def run():
        with HostWorker() as w:
            fut = tprev.generate_preview(
                NiftiImage(data=ct, affine=aff), NiftiImage(data=seg, affine=aff), CMAP, out,
                worker=w if worker else None, device="cpu", spans=spans)
            assert (fut is not None) == worker
            if worker:
                assert fut.result() is None

    drawn = _montage(monkeypatch, run)
    assert set(spans) == {"preview_fronts", "preview_render"}
    with Image.open(out) as im:
        rgb = np.asarray(im)
    assert rgb.shape == (660, 1760, 3)
    np.testing.assert_array_equal(rgb, drawn[0])
    for group, panel in zip(tprev.ROI_GROUPS, np.array_split(rgb / 255.0, 5, axis=1)):
        saturation = panel.max(axis=-1) - panel.min(axis=-1)
        assert (saturation > 0.15).sum() > 50, group


def test_montage_same_bytes_from_device_and_host_fronts(phantom, tmp_path):
    """The render is deterministic and reads only the fronts: the pass's
    fronts and the host version's give byte-identical PNGs; a study whose
    label map is on another grid than the CT draws no CT underlay."""
    ct, seg = phantom
    dev = tprev._group_fronts_device(torch.from_numpy(seg), INV, N_LABELS)
    host = tprev._group_fronts_from_depths(tprev._label_depths(seg, N_LABELS), INV)
    for name, fronts in (("dev", dev), ("host", host)):
        tprev._render_montage(ct, fronts, 1.5, tmp_path / f"{name}.png")
    assert (tmp_path / "dev.png").read_bytes() == (tmp_path / "host.png").read_bytes()
    tprev._render_montage(None, dev, 1.5, tmp_path / "bare.png")
    with Image.open(tmp_path / "bare.png") as a, Image.open(tmp_path / "dev.png") as b:
        bare, full = np.asarray(a), np.asarray(b)
    assert bare.shape == full.shape and (bare != full).any()
    gray = (bare.max(-1) == bare.min(-1)) & (bare.max(-1) > 0)
    assert gray.sum() < 2000   # the titles only: no slab


def test_failed_render_on_worker_is_logged(phantom, tmp_path, monkeypatch, caplog):
    """A render that raises on the HostWorker is logged as a warning, its
    Future holds None, and the worker's barrier does not raise: the
    reference's `suppress=True`."""
    ct, seg = phantom
    aff = np.diag([*SPACING, 1.0])

    def broken(*a):
        raise RuntimeError("injected render failure")

    monkeypatch.setattr(tprev, "_render_montage", broken)
    caplog.set_level(logging.WARNING)
    with HostWorker() as w:
        fut = tprev.generate_preview(NiftiImage(data=ct, affine=aff),
                                     NiftiImage(data=seg, affine=aff), CMAP,
                                     tmp_path / "p.png", worker=w, device="cpu")
        assert fut.result() is None
    assert "Deferred stage preview-render failed" in caplog.text
    assert not (tmp_path / "p.png").exists()
    with pytest.raises(RuntimeError, match="injected"):   # inline: raised
        tprev.generate_preview(NiftiImage(data=ct, affine=aff),
                               NiftiImage(data=seg, affine=aff), CMAP,
                               tmp_path / "p.png", device="cpu")
