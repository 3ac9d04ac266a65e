"""The port's augmentation (`boa_tpu_torch/train/augment.py`) against the
reference's on the CPU. The two packages draw different random numbers, so
each reference transform is run on a key, its parameters are drawn again
from that key as the reference draws them, and the port's apply is held to
the reference's output at those parameters (1e-5). The helpers are held
directly; the pipelines are checked for shapes, dtypes, determinism under
one seed and the identity at probability zero."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boa_tpu.train import augment as ra
from boa_tpu_torch.train import augment as pa

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.array(a))


def _x(seed, shape=(2, 14, 12, 10, 2)):
    r = np.random.default_rng(seed)
    return (r.normal(size=shape) * 2 + 0.5).astype(np.float32)


def _y(seed, shape=(2, 14, 12, 10), n=4):
    return np.random.default_rng(seed).integers(0, n, size=shape).astype(np.int32)


def _close(a, b, **tol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), **(tol or TOL))


# ---------------------------------------------------------------- helpers
def test_helpers_match_reference():
    r = np.random.default_rng(0)
    for ang in (np.zeros(3), r.uniform(-1, 1, 3), np.array([0.0, 0.0, 0.7])):
        ang = ang.astype(np.float32)
        _close(pa._rotation_matrix(_t(ang)), ra._rotation_matrix(jnp.asarray(ang)))
    mat = (r.normal(size=(3, 3)) * 0.3 + np.eye(3)).astype(np.float32)
    coords = pa._affine_coords((9, 8, 7), _t(mat))
    _close(coords, ra._affine_coords((9, 8, 7), jnp.asarray(mat)))
    vol = r.normal(size=(9, 8, 7, 3)).astype(np.float32)
    c = coords.numpy()
    _close(pa._sample_trilinear(_t(vol), _t(c)), ra._sample_trilinear(jnp.asarray(vol),
                                                                     jnp.asarray(c)))
    _close(pa._sample_trilinear(_t(vol[..., 0]), _t(c)),
           ra._sample_trilinear(jnp.asarray(vol[..., 0]), jnp.asarray(c)))
    lab = r.integers(0, 5, size=(9, 8, 7)).astype(np.int32)
    np.testing.assert_array_equal(pa._sample_nearest(_t(lab), _t(c)).numpy(),
                                  np.asarray(ra._sample_nearest(jnp.asarray(lab),
                                                                jnp.asarray(c))))
    for sigma, radius in ((0.5, 3), (1.3, 6), (1e-4, 2)):
        _close(pa._gauss_kernel1d(torch.tensor(sigma), radius),
               ra._gauss_kernel1d(jnp.float32(sigma), radius))
    mask = np.array([True, False])
    a, b = _x(1), _x(2)
    np.testing.assert_array_equal(pa._blend(_t(mask), _t(a), _t(b)).numpy(),
                                  np.asarray(ra._blend(jnp.asarray(mask), jnp.asarray(a),
                                                       jnp.asarray(b))))


# ---------------------------------------------------------------- transforms
def _spatial_params(key, n, p_rot, p_scale, rot_max, scale_range, in_plane):
    """The reference's draws in `spatial_transform.one`, per sample."""
    angles, scales, ident = [], [], []
    for k in jax.random.split(key, n):
        k1, k2, k3, k4 = jax.random.split(k, 4)
        do_rot = bool(jax.random.uniform(k1) < p_rot)
        do_scale = bool(jax.random.uniform(k2) < p_scale)
        a = np.asarray(jax.random.uniform(k3, (3,), minval=-rot_max, maxval=rot_max)) \
            if do_rot else np.zeros(3, np.float32)
        if in_plane:
            a = a * np.array([0.0, 0.0, 1.0], np.float32)
        s = float(jax.random.uniform(k4, (), minval=scale_range[0], maxval=scale_range[1])) \
            if do_scale else 1.0
        angles.append(a)
        scales.append(s)
        ident.append(not (do_rot or do_scale))
    return (torch.tensor(np.stack(angles), dtype=torch.float32),
            torch.tensor(scales, dtype=torch.float32), torch.tensor(ident))


@pytest.mark.parametrize("kw", [dict(p_rotation=1.0, p_scaling=1.0),
                                dict(p_rotation=0.5, p_scaling=0.5, rot_max=0.96,
                                     scale_range=(0.6, 1.6)),
                                dict(p_rotation=0.0, p_scaling=0.0)],
                         ids=["always", "da5_half", "never"])
@pytest.mark.parametrize("two_d", [False, True])
def test_spatial_apply_matches_reference(kw, two_d):
    shape = (3, 14, 12, 1 if two_d else 10)
    x, y = _x(3, shape + (2,)), _y(4, shape)
    full = dict(p_rotation=0.2, p_scaling=0.2, rot_max=0.5235987755982988,
                scale_range=(0.7, 1.4))
    full.update(kw)
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        xo, yo = ra.spatial_transform(key, jnp.asarray(x), jnp.asarray(y), **full)
        angles, scale, ident = _spatial_params(key, shape[0], full["p_rotation"],
                                               full["p_scaling"], full["rot_max"],
                                               full["scale_range"], two_d)
        gx, gy = pa.spatial_apply(_t(x), _t(y), angles, scale, ident)
        _close(gx, xo)
        # labels: nearest sampling, equal away from rounding ties
        assert (gy.numpy() == np.asarray(yo)).mean() > 0.999


def test_spatial_apply_warps_seg_channels_together():
    x, y = _x(5), _y(6)
    segs = np.stack([y, (y + 1) % 4], axis=-1)
    key = jax.random.PRNGKey(7)
    xo, so = ra.spatial_transform(key, jnp.asarray(x), jnp.asarray(segs), p_rotation=1.0,
                                  p_scaling=1.0)
    prm = _spatial_params(key, 2, 1.0, 1.0, 0.5235987755982988, (0.7, 1.4), False)
    gx, gs = pa.spatial_apply(_t(x), _t(segs), *prm)
    _close(gx, xo)
    assert gs.shape == so.shape and (gs.numpy() == np.asarray(so)).mean() > 0.999


@pytest.mark.parametrize("p", [1.0, 0.5])
def test_noise_apply_matches_reference(p):
    x = _x(8)
    key = jax.random.PRNGKey(1)
    want = ra.gaussian_noise(key, jnp.asarray(x), p=p, max_var=0.1)
    k1, k2, k3 = jax.random.split(key, 3)
    prm = dict(mask=_t(jax.random.uniform(k1, (2,)) < p),
               var=_t(jax.random.uniform(k2, (2,), minval=0.0, maxval=0.1)),
               noise=_t(jax.random.normal(k3, x.shape)))
    _close(pa.noise_apply(_t(x), **prm), want)


@pytest.mark.parametrize("sigma_range", [(0.5, 1.0), (0.3, 1.5)])
def test_blur_apply_matches_reference(sigma_range):
    x = _x(9, (2, 16, 14, 12, 1))
    key = jax.random.PRNGKey(2)
    want = ra.gaussian_blur(key, jnp.asarray(x), p=1.0, sigma_range=sigma_range)
    k1, k2 = jax.random.split(key)
    sig = [float(jax.random.uniform(k, (), minval=sigma_range[0], maxval=sigma_range[1]))
           for k in jax.random.split(k2, 2)]
    got = pa.blur_apply(_t(x), mask=torch.tensor([True, True]), sigma=torch.tensor(sig),
                        radius=pa.blur_radius(x.shape, sigma_range))
    _close(got, want)


@pytest.mark.parametrize("name", ["brightness", "contrast", "gamma", "gamma_inv"])
def test_factor_applies_match_reference(name):
    x = _x(10)
    key = jax.random.PRNGKey(3)
    rng = (0.7, 1.5)
    k1, k2 = jax.random.split(key)
    mask = _t(jax.random.uniform(k1, (2,)) < 0.6)
    factor = _t(jax.random.uniform(k2, (2, 1, 1, 1, 1), minval=rng[0], maxval=rng[1]))
    if name == "brightness":
        want = ra.brightness(key, jnp.asarray(x), p=0.6, rng=rng)
        got = pa.brightness_apply(_t(x), mask, factor)
    elif name == "contrast":
        want = ra.contrast(key, jnp.asarray(x), p=0.6, rng=rng)
        got = pa.contrast_apply(_t(x), mask, factor)
    else:
        inv = name == "gamma_inv"
        want = ra.gamma(key, jnp.asarray(x), p=0.6, rng=rng, invert=inv)
        got = pa.gamma_apply(_t(x), mask, factor, invert=inv)
    _close(got, want, rtol=1e-5, atol=2e-5)


@pytest.mark.parametrize("zoom_range", [(0.5, 1.0), (0.4, 1.0)])
def test_lowres_apply_matches_reference(zoom_range):
    x = _x(11, (4, 16, 12, 10, 1))
    for seed in range(2):
        key = jax.random.PRNGKey(seed)
        want = ra.simulate_low_resolution(key, jnp.asarray(x), p=0.8, zoom_range=zoom_range)
        k1, k2 = jax.random.split(key)
        level = torch.tensor([int(jax.random.randint(k, (), 0, 4))
                              for k in jax.random.split(k2, 4)])
        mask = _t(jax.random.uniform(k1, (4,)) < 0.8)
        got = pa.lowres_apply(_t(x), mask, level, zoom_range=zoom_range)
        _close(got, want)


def test_mirror_apply_matches_reference():
    x, y = _x(12), _y(13)
    key = jax.random.PRNGKey(4)
    axes = (0, 1, 2)
    xo, yo = ra.mirror(key, jnp.asarray(x), jnp.asarray(y), axes=axes)
    flips = torch.tensor([[bool(jax.random.uniform(k) < 0.5) for k in jax.random.split(ks, 3)]
                          for ks in jax.random.split(key, 2)])
    gx, gy = pa.mirror_apply(_t(x), _t(y), flips, axes)
    np.testing.assert_array_equal(gx.numpy(), np.asarray(xo))
    np.testing.assert_array_equal(gy.numpy(), np.asarray(yo))


def test_binary_noise_apply_matches_reference():
    r = np.random.default_rng(14)
    onehot = np.zeros((12, 11, 10, 3), np.float32)
    onehot[3:8, 3:8, 3:7, 0] = 1
    onehot[1:5, 6:10, 2:9, 1] = 1
    onehot[..., 2] = r.random((12, 11, 10)) > 0.7
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        want = ra._binary_noise(key, jnp.asarray(onehot), p=0.8, max_radius=4)
        k1, k2, k3 = jax.random.split(key, 3)
        got = pa.binary_noise_apply(
            _t(onehot), apply=_t(jax.random.uniform(k1, (3,)) < 0.8),
            dilate=_t(jax.random.uniform(k2, (3,)) < 0.5),
            radius=_t(jax.random.randint(k3, (3,), 1, 5)), max_radius=4)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------- pipelines
def _gen(seed):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


@pytest.mark.parametrize("fn", ["augment_batch", "augment_batch_da5"])
def test_pipelines_shapes_determinism(fn):
    x, y = _x(15, (2, 16, 16, 16, 1)), _y(16, (2, 16, 16, 16))
    f = getattr(pa, fn)
    a = f(_gen(3), _t(x), _t(y), mirror_axes=(0, 1, 2))
    b = f(_gen(3), _t(x), _t(y), mirror_axes=(0, 1, 2))
    c = f(_gen(4), _t(x), _t(y), mirror_axes=(0, 1, 2))
    assert a[0].shape == x.shape and a[1].shape == y.shape and a[1].dtype == torch.int32
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[0], c[0])
    assert torch.isfinite(a[0]).all()
    assert set(np.unique(a[1].numpy())) <= set(np.unique(y))


def test_transforms_at_probability_zero_are_identity():
    x, y = _x(17), _y(18)
    g = _gen(0)
    gx, gy = pa.spatial_transform(g, _t(x), _t(y), p_rotation=0.0, p_scaling=0.0)
    assert torch.equal(gx, _t(x)) and torch.equal(gy, _t(y))
    for f in (pa.gaussian_noise, pa.gaussian_blur, pa.brightness, pa.contrast,
              pa.simulate_low_resolution, pa.gamma):
        assert torch.equal(f(g, _t(x), 0.0), _t(x)), f.__name__


def test_cascade_pipeline():
    x, y = _x(19, (2, 16, 16, 16, 1)), _y(20, (2, 16, 16, 16), n=3)
    prev = _y(21, (2, 16, 16, 16), n=3)
    xo, yo = pa.augment_batch_cascade(_gen(5), _t(x), _t(y), _t(prev), (1, 2),
                                      mirror_axes=(0, 1))
    assert xo.shape == (2, 16, 16, 16, 3) and yo.dtype == torch.int32
    onehot = xo[..., 1:]
    assert set(np.unique(onehot.numpy())) <= {0.0, 1.0}
    xr, yr = ra.augment_batch_cascade(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(y),
                                      jnp.asarray(prev), (1, 2), mirror_axes=(0, 1))
    assert xr.shape == tuple(xo.shape) and yr.dtype == jnp.int32
