"""The port's affine registration (boa_tpu_torch/ops/registration.py) against
the reference's (boa_tpu/ops/registration.py, JAX), on the CPU, on volumes
made from a seed with numpy.

Bars: `affine_warp` orders 0 and 1 within 1e-5 (edges and outside voxels
included), `params_to_matrix` within 1e-6, `ncc_loss` and its gradient with
respect to every parameter within 1e-5; `register_affine` on the reference
test's synthetic head and on a perturbed atlas reaches the reference test's
bars, with the rotation within 0.5 degrees and the translation within 0.3
voxels of the JAX result.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage as ndi

from boa_tpu.ops import registration as jreg
from boa_tpu_torch.io import nifti as tn
from boa_tpu_torch.ops import registration as treg

ATLAS = Path(treg.__file__).resolve().parents[1] / "resources" / "ct_brain_atlas_1mm.nii.gz"


@pytest.fixture(autouse=True)
def _two_threads():
    """The registration's hundreds of small steps run faster on two
    threads than on every core, and far faster when the suite's workers
    share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _head(n=64):
    """The synthetic head of tests/test_registration.py."""
    g = np.mgrid[:n, :n, :n].astype(np.float32)
    c = n / 2
    head = ((((g[0] - c) / (0.34 * n)) ** 2 + ((g[1] - c) / (0.4 * n)) ** 2
             + ((g[2] - c) / (0.3 * n)) ** 2) <= 1).astype(np.float32)
    head += 0.4 * ((((g[0] - c) / (0.15 * n)) ** 2
                    + ((g[1] - c + 6) / (0.12 * n)) ** 2
                    + ((g[2] - c - 2) / (0.14 * n)) ** 2) <= 1)
    head += 0.25 * ((((g[0] - c - 8) / (0.1 * n)) ** 2
                     + ((g[1] - c - 6) / (0.11 * n)) ** 2
                     + ((g[2] - c + 4) / (0.08 * n)) ** 2) <= 1)
    return head


def _params(seed: int) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 1.5, 3).astype(np.float32),      # translation
            rng.normal(0, 0.15, 3).astype(np.float32),     # rotation
            rng.normal(0, 0.05, 3).astype(np.float32),     # log-scale
            rng.normal(0, 0.05, 3).astype(np.float32)]     # shear


def _jparams(leaves):
    return jreg.AffineParams(*(jnp.asarray(a) for a in leaves))


def _tparams(leaves, grad=False):
    return treg.AffineParams(*(torch.tensor(a, requires_grad=grad) for a in leaves))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_params_to_matrix_matches_reference(seed):
    leaves = _params(seed)
    want = np.asarray(jreg.params_to_matrix(_jparams(leaves), (20, 18, 16), (22, 17, 15)))
    got = treg.params_to_matrix(_tparams(leaves), (20, 18, 16), (22, 17, 15)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    ident = treg.params_to_matrix(treg.identity_params(), (10, 12, 14), (10, 12, 14))
    np.testing.assert_allclose(ident.numpy(), np.concatenate([np.eye(3), np.zeros((3, 1))], 1),
                               atol=1e-5)


def _matrices():
    """Identity, a scale that lands exactly on the top edge, a rotation with
    a shift that sends part of the grid outside, and random affines."""
    out = [np.concatenate([np.eye(3), np.zeros((3, 1))], 1),
           np.concatenate([np.diag([19 / 13, 17 / 11, 15 / 9]), np.zeros((3, 1))], 1)]
    th = np.radians(20.0)
    rot = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0], [0, 0, 1]])
    out.append(np.concatenate([rot, np.array([[2.5], [-3.25], [1.5]])], 1))
    for seed in (3, 4):
        out.append(np.asarray(jreg.params_to_matrix(_jparams(_params(seed)), (14, 12, 10),
                                                    (20, 18, 16))))
    return [m.astype(np.float32) for m in out]


@pytest.mark.parametrize("order", [0, 1])
@pytest.mark.parametrize("k", range(5))
def test_affine_warp_matches_reference(order, k):
    rng = np.random.default_rng(10 + k)
    vol = rng.normal(0, 1, (20, 18, 16)).astype(np.float32)
    if order == 0:
        vol = rng.integers(0, 9, (20, 18, 16)).astype(np.uint8)
    m = _matrices()[k]
    out_shape = (14, 12, 10)
    want = np.asarray(jreg.affine_warp(jnp.asarray(vol), jnp.asarray(m), out_shape,
                                       order=order, cval=-7.0 if order else 0.0))
    got = treg.affine_warp(torch.from_numpy(vol), torch.from_numpy(m), out_shape,
                           order=order, cval=-7.0 if order else 0.0).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    if k == 2:   # the shifted rotation leaves part of the grid outside
        assert (want == (-7.0 if order else 0)).any()


def _loss_inputs():
    rng = np.random.default_rng(5)
    fixed = ndi.gaussian_filter(rng.normal(size=(18, 16, 14)), 2).astype(np.float32)
    moving = ndi.gaussian_filter(rng.normal(size=(17, 16, 15)), 2).astype(np.float32)
    return fixed, moving


@pytest.mark.parametrize("seed", [0, 1])
def test_ncc_loss_and_gradient_match_reference(seed):
    fixed, moving = _loss_inputs()
    leaves = _params(seed)

    def jloss(p):
        m = jreg.params_to_matrix(p, fixed.shape, moving.shape)
        return jreg.ncc_loss(jnp.asarray(fixed),
                             jreg.affine_warp(jnp.asarray(moving), m, fixed.shape))

    want, jgrads = jax.jit(jax.value_and_grad(jloss))(_jparams(leaves))
    p = _tparams(leaves, grad=True)
    m = treg.params_to_matrix(p, fixed.shape, moving.shape)
    got = treg.ncc_loss(torch.from_numpy(fixed),
                        treg.affine_warp(torch.from_numpy(moving), m, fixed.shape))
    got.backward()
    assert abs(got.item() - float(want)) <= 1e-5 * max(1.0, abs(float(want)))
    for name, jg, tp in zip(treg.AffineParams._fields, jgrads, p):
        np.testing.assert_allclose(tp.grad.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-5,
                                   err_msg=name)


def test_downsample_matches_reference():
    vol = np.random.default_rng(6).normal(size=(19, 17, 13)).astype(np.float32)
    for f in (1, 2, 4):
        np.testing.assert_allclose(treg._downsample(torch.from_numpy(vol), f).numpy(),
                                   np.asarray(jreg._downsample(jnp.asarray(vol), f)),
                                   rtol=1e-6, atol=1e-6)


def _same_registration(tp, jp):
    rot_t, rot_j = np.degrees(np.asarray(tp.rotation)), np.degrees(np.asarray(jp.rotation))
    assert np.abs(rot_t - rot_j).max() <= 0.5, (rot_t, rot_j)
    assert np.abs(np.asarray(tp.translation) - np.asarray(jp.translation)).max() <= 0.3


def test_register_recovers_rotation_and_shift_as_reference():
    """tests/test_registration.py's case through both packages: the port
    reaches the reference test's bars and the reference's parameters."""
    head = _head()
    rng = np.random.default_rng(0)
    fixed = head + 0.02 * rng.standard_normal(head.shape).astype(np.float32)
    moving = ndi.shift(ndi.rotate(head, 12.0, axes=(1, 0), reshape=False, order=1),
                       (3.0, -2.0, 1.5), order=1)
    spans = {}
    p, mat, ncc = treg.register_affine(fixed, moving, levels=(4, 2), steps_per_level=120,
                                       device="cpu", spans=spans)
    jp, jmat, jncc = jreg.register_affine(fixed, moving, levels=(4, 2), steps_per_level=120)
    assert sorted(spans) == ["level_2", "level_4"]
    assert ncc > 0.95 and abs(ncc - jncc) < 1e-3
    assert np.degrees(float(p.rotation[2])) == pytest.approx(12.0, abs=1.5)
    assert float(p.translation[0]) == pytest.approx(3.0, abs=0.7)
    assert float(p.translation[1]) == pytest.approx(-2.0, abs=0.7)
    _same_registration(p, jp)
    # the scale stays free, the shear locked at 0 (its gradient zeroed)
    assert not np.asarray(p.shear).any() and np.asarray(p.log_scale).any()
    lab = (head > 0.5).astype(np.uint8)
    lab_moving = ndi.shift(ndi.rotate(lab, 12.0, axes=(1, 0), reshape=False, order=0),
                           (3.0, -2.0, 1.5), order=0)
    back = treg.warp_labels(lab_moving, mat, lab.shape, device="cpu")
    assert back.dtype == np.uint8
    dice = 2 * np.logical_and(back > 0, lab > 0).sum() / (lab.sum() + (back > 0).sum())
    assert dice > 0.93
    # the same matrix through the reference's warp: the same labels
    np.testing.assert_array_equal(treg.warp_labels(lab_moving, jmat, lab.shape, device="cpu"),
                                  np.asarray(jreg.warp_labels(lab_moving, jmat, lab.shape)))


def test_atlas_registration_recovers_known_perturbation():
    """tests/test_registration.py's perturbed-atlas case on the port's copy
    of the atlas at 2 mm (10 degrees in-plane, scale 1.05, a shift): NCC >
    0.9, mean landmark error < 2 mm, and the reference's parameters."""
    deg, scale = 10.0, 1.05
    atlas = ndi.zoom(np.asarray(tn.load(ATLAS).data, np.float32), 0.5, order=1)
    atlas = np.clip(atlas, 0.0, 100.0)
    th = np.radians(deg)
    a = np.array([[np.cos(th), -np.sin(th), 0.0], [np.sin(th), np.cos(th), 0.0],
                  [0.0, 0.0, 1.0]]) * scale
    c = (np.asarray(atlas.shape, np.float64) - 1) / 2
    offset = c + np.array([2.0, -1.5, 1.0]) - a @ c
    moving = ndi.affine_transform(atlas, a, offset=offset, order=1)
    p, mat, ncc = treg.register_affine(atlas, moving, levels=(4, 2), steps_per_level=150,
                                       device="cpu")
    jp, _, jncc = jreg.register_affine(atlas, moving, levels=(4, 2), steps_per_level=150)
    assert ncc > 0.9 and abs(ncc - jncc) < 1e-3
    ainv = np.linalg.inv(a)
    marks = [c, c + (15, 0, 0), c - (15, 0, 0), c + (0, 15, 0), c + (0, 0, 12),
             c + (10, 10, -8)]
    errs = [np.linalg.norm(mat[:3, :3] @ m + mat[:3, 3] - ainv @ (m - offset)) * 2.0
            for m in marks]
    assert float(np.mean(errs)) < 2.0, errs
    _same_registration(p, jp)


def test_registration_defaults_to_the_card():
    """Without a device the registration asks for CUDA and raises where
    there is none; it never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        treg.register_affine(np.zeros((8, 8, 8), np.float32), np.zeros((8, 8, 8), np.float32),
                             levels=(2,), steps_per_level=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        treg.warp_labels(np.zeros((4, 4, 4), np.uint8), np.eye(4)[:3], (4, 4, 4))
