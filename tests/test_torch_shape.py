"""The port's shape features (boa_tpu_torch/measure/shape.py) against the
reference's (boa_tpu/measure/shape.py) on the reference's own cases
(tests/test_shape.py: the single-voxel octahedron, a sphere, an ellipsoid,
an anisotropic box, every marching-cubes configuration, empty and full
masks) and on seeded random blobs. Host numpy on both sides: every
feature, the mesh area and volume and the vertex set equal to 1e-12
relative."""

import numpy as np
import pytest
from scipy import ndimage

from boa_tpu.measure import shape as js
from boa_tpu_torch.measure import shape as ts


def _ellipsoid(a, b, c, pad=3):
    gx = np.arange(-(a + pad), a + pad + 1)
    gy = np.arange(-(b + pad), b + pad + 1)
    gz = np.arange(-(c + pad), c + pad + 1)
    X, Y, Z = np.meshgrid(gx, gy, gz, indexing="ij")
    return (X / a) ** 2 + (Y / b) ** 2 + (Z / c) ** 2 <= 1.0


def _blob(seed, shape=(30, 26, 22)):
    rng = np.random.default_rng(seed)
    return ndimage.gaussian_filter(rng.random(shape), 2.0) > 0.5


CASES = {
    "octahedron": (np.ones((1, 1, 1), bool), (1.0, 1.0, 1.0)),
    "sphere": (_ellipsoid(12, 12, 12), (1.0, 1.0, 1.0)),
    "ellipsoid": (_ellipsoid(20, 10, 5), (1.0, 1.0, 1.0)),
    "box_anisotropic": (np.ones((10, 8, 6), bool), (1.5, 1.5, 5.0)),
    "empty": (np.zeros((4, 4, 4), bool), (1.0, 1.0, 1.0)),
    "full": (np.ones((3, 3, 3), bool), (2.0, 1.0, 1.0)),
    "speckle": (np.random.default_rng(7).random((12, 13, 11)) > 0.6, (0.8, 0.8, 2.5)),
    "blob_0": (_blob(0), (1.5, 1.5, 3.0)),
    "blob_1": (_blob(1), (0.7, 0.9, 1.25)),
    "blob_2": (_blob(2, (40, 12, 9)), (1.0, 1.0, 1.0)),
    "large_diameter_pass": (_ellipsoid(40, 30, 8, pad=1), (1.0, 1.0, 1.0)),
}


def _same(got: dict, want: dict) -> None:
    assert list(got) == list(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-12, abs=0.0), k


@pytest.mark.parametrize("name", list(CASES))
def test_shape_features_equal(name):
    mask, spacing = CASES[name]
    _same(ts.shape_features(mask, spacing), js.shape_features(mask, spacing))


@pytest.mark.parametrize("name", ["octahedron", "sphere", "speckle", "blob_0"])
def test_mesh_area_volume_vertices_equal(name):
    mask, spacing = CASES[name]
    a1, v1, p1 = ts._mesh_area_volume_verts(mask, spacing)
    a0, v0, p0 = js._mesh_area_volume_verts(mask, spacing)
    assert a1 == pytest.approx(a0, rel=1e-12) and v1 == pytest.approx(v0, rel=1e-12)
    np.testing.assert_array_equal(p1, p0)


def test_every_cube_configuration():
    """All 256 corner patterns of one cell, and the generated triangle
    tables equal."""
    for t1, t0 in zip(ts._tri_table(), js._tri_table()):
        np.testing.assert_array_equal(t1, t0)
    for cfg in range(256):
        m = np.zeros((2, 2, 2), bool)
        for i in range(8):
            if (cfg >> i) & 1:
                m[i & 1, (i >> 1) & 1, (i >> 2) & 1] = True
        _same(ts.shape_features(m, (1.0, 2.0, 3.0)), js.shape_features(m, (1.0, 2.0, 3.0)))


def test_single_voxel_is_the_exact_octahedron():
    area, vol, verts = ts._mesh_area_volume_verts(np.ones((1, 1, 1), bool), (1, 1, 1))
    assert area == pytest.approx(np.sqrt(3.0), rel=1e-12)
    assert vol == pytest.approx(1.0 / 6.0, rel=1e-12)
    assert len(verts) == 6
