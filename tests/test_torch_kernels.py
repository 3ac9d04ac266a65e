"""Card-only checks of the hand-written CUDA kernels against their plain
versions (boa_tpu_torch/ops/rowconv.py), same inputs on the card.

These need an NVIDIA GPU and the CUDA toolkit; they skip elsewhere. The
file imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels.py

Tolerances: bf16 outputs at rtol = atol = 2e-2 (the reference's
tests/test_rowconv.py bar); the per-channel sums, accumulated with atomics
in a run-dependent order, within 1e-2 of the largest sum of squares.
"""

import numpy as np
import pytest
import torch

from boa_tpu_torch.ops import rowconv as rc

pytestmark = pytest.mark.gpu


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _norm(rng, n, cin, dev):
    return rc.NormAct(
        mean=torch.tensor(rng.normal(size=(n, cin)), dtype=torch.float32, device=dev),
        inv_std=torch.tensor(1.0 + rng.random((n, cin)), dtype=torch.float32, device=dev),
        gamma=torch.tensor(1.0 + 0.1 * rng.normal(size=cin), dtype=torch.float32, device=dev),
        beta=torch.tensor(0.1 * rng.normal(size=cin), dtype=torch.float32, device=dev),
        slope=0.01)


def _rel_sums(got, ref):
    return float((got - ref).abs().max() / ref[:, 1].abs().max().clamp_min(1e-6))


@pytest.mark.parametrize("shape,cin,cout,stride,slope_vec,out_f32", [
    ((1, 10, 12, 14), 1, 32, 1, False, False),
    ((2, 9, 6, 37), 8, 16, 1, False, True),
    ((2, 16, 12, 40), 32, 32, 1, True, False),
    ((1, 8, 10, 12), 64, 32, 1, True, False),
    ((1, 6, 6, 6), 24, 40, 1, False, False),
    ((2, 16, 12, 40), 32, 64, 2, False, False),
    ((1, 9, 7, 11), 16, 16, 2, False, True),
])
def test_conv_kernel_matches_plain(cuda, shape, cin, cout, stride, slope_vec,
                                   out_f32):
    rng = np.random.default_rng(0)
    n = shape[0]
    x = torch.tensor(rng.normal(size=shape + (cin,)) * 2 + 0.3,
                     dtype=torch.bfloat16, device=cuda)
    w = torch.tensor(rng.normal(size=(3, 3, 3, cin, cout)) * 0.2,
                     dtype=torch.float32, device=cuda)
    b = torch.tensor(rng.normal(size=cout) * 0.1, dtype=torch.float32, device=cuda)
    norm = _norm(rng, n, cin, cuda)
    slope = (torch.tensor(rng.random(cin), dtype=torch.float32, device=cuda)
             if slope_vec else 0.01)
    out_dtype = torch.float32 if out_f32 else torch.bfloat16
    fn = rc.conv3d_rows if stride == 1 else rc.conv3d_rows_stride2
    plain = rc.conv3d_rows_plain if stride == 1 else rc.conv3d_rows_stride2_plain
    before = dict(rc.LAUNCHES)
    y, s = fn(x, norm, w, b, slope=slope, out_dtype=out_dtype)
    torch.cuda.synchronize()
    name = "conv3d_rows" if stride == 1 else "conv3d_rows_stride2"
    assert rc.LAUNCHES[name] == before[name] + 1
    yr, sr = plain(x, norm, w, b, slope=slope, out_dtype=out_dtype)
    assert y.shape == yr.shape and y.dtype == out_dtype
    torch.testing.assert_close(y.float(), yr.float(), rtol=2e-2, atol=2e-2)
    assert _rel_sums(s, sr) < 1e-2


@pytest.mark.parametrize("shape,cin,cout,out_f32", [
    ((1, 6, 5, 7), 64, 32, False),
    ((2, 4, 6, 8), 16, 8, True),
    ((1, 3, 5, 9), 20, 12, False),
])
def test_transp_kernel_matches_plain(cuda, shape, cin, cout, out_f32):
    rng = np.random.default_rng(1)
    x = torch.tensor(rng.normal(size=shape + (cin,)), dtype=torch.bfloat16,
                     device=cuda)
    w = torch.tensor(rng.normal(size=(2, 2, 2, cin, cout)) * 0.3,
                     dtype=torch.float32, device=cuda)
    out_dtype = torch.float32 if out_f32 else torch.bfloat16
    y = rc.transpconv2_rows(x, w, out_dtype=out_dtype)
    torch.cuda.synchronize()
    yr = rc.transpconv2_rows_plain(x, w, out_dtype=out_dtype)
    assert y.shape == yr.shape
    torch.testing.assert_close(y.float(), yr.float(), rtol=2e-2, atol=2e-2)


def test_main_path_shapes(cuda):
    """The 128^3 shapes of a total_fast tile, including a batch of two."""
    rng = np.random.default_rng(2)
    for n, cin, cout in ((2, 1, 32), (1, 32, 32), (1, 64, 32)):
        x = torch.tensor(rng.normal(size=(n, 128, 128, 128, cin)),
                         dtype=torch.bfloat16, device=cuda)
        w = torch.tensor(rng.normal(size=(3, 3, 3, cin, cout)) * 0.05,
                         dtype=torch.float32, device=cuda)
        norm = _norm(rng, n, cin, cuda)
        y, s = rc.conv3d_rows(x, norm, w, None, slope=0.01)
        yr, sr = rc.conv3d_rows_plain(x, norm, w, None, slope=0.01)
        torch.testing.assert_close(y.float(), yr.float(), rtol=2e-2, atol=2e-2)
        assert _rel_sums(s, sr) < 1e-2
