"""Card-only checks of the hand-written CUDA kernels against their plain
versions (boa_tpu_torch/ops/rowconv.py, boa_tpu_torch/ops/pallas_conv.py),
same inputs on the card.

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


@pytest.mark.parametrize("cout", [16, 32, 64])
@pytest.mark.parametrize("shape,cin,strided", [
    ((2, 9, 7, 11), 32, False),
    ((2, 9, 7, 11), 32, True),
    ((1, 20, 17, 35), 16, True),
    ((1, 5, 3, 40), 64, False),
    ((2, 6, 9, 5), 24, True),
])
def test_stride2_kernel_matches_plain(cuda, shape, cin, strided, cout):
    """K2 (csrc/stride2conv.cu) at extents that fill no whole tile, on a
    whole tensor and on a channel slice of a wider buffer (the concat)."""
    rng = np.random.default_rng(cin + cout + shape[1])
    n = shape[0]
    x = torch.tensor(rng.normal(size=shape + (cin,)) * 2 + 0.3, dtype=torch.bfloat16,
                     device=cuda)
    if strided:
        buf = torch.tensor(rng.normal(size=shape + (cin + 16,)), dtype=torch.bfloat16,
                           device=cuda)
        buf[..., 16:] = x
        x = buf[..., 16:]
    w = torch.tensor(rng.normal(size=(3, 3, 3, cin, cout)) * 0.2, dtype=torch.float32,
                     device=cuda)
    b = torch.tensor(rng.normal(size=cout) * 0.1, dtype=torch.float32, device=cuda)
    norm = _norm(rng, n, cin, cuda)
    for out_dtype in (torch.bfloat16, torch.float32):
        before = rc.LAUNCHES["conv3d_rows_stride2"]
        y, s = rc.conv3d_rows_stride2(x, norm, w, b, slope=0.01, out_dtype=out_dtype)
        torch.cuda.synchronize()
        assert rc.LAUNCHES["conv3d_rows_stride2"] == before + 1
        yr, sr = rc.conv3d_rows_stride2_plain(x, norm, w, b, slope=0.01, out_dtype=out_dtype)
        assert y.shape == yr.shape == (n,) + tuple((v + 1) // 2 for v in shape[1:]) + (cout,)
        torch.testing.assert_close(y.float(), yr.float(), rtol=2e-2, atol=2e-2)
        assert _rel_sums(s, sr) < 1e-2


@pytest.mark.parametrize("out_f32", [False, True])
@pytest.mark.parametrize("cout", [8, 16, 32, 64])
def test_transp_kernel_into_a_concat_slice(cuda, cout, out_f32):
    """K3 with its bias into the first cout channels of a wider buffer: the
    slice matches the plain version, the other channels keep their bits."""
    rng = np.random.default_rng(cout)
    n, X, Y, Z, cin = 2, 5, 6, 9, 48
    x = torch.tensor(rng.normal(size=(n, X, Y, Z, cin)), dtype=torch.bfloat16, device=cuda)
    w = torch.tensor(rng.normal(size=(2, 2, 2, cin, cout)) * 0.2, dtype=torch.float32,
                     device=cuda)
    b = torch.tensor(rng.normal(size=cout), dtype=torch.float32, device=cuda)
    out_dtype = torch.float32 if out_f32 else torch.bfloat16
    buf = torch.tensor(rng.normal(size=(n, 2 * X, 2 * Y, 2 * Z, cout + 24)), dtype=out_dtype,
                       device=cuda)
    rest = buf[..., cout:].clone()
    before = rc.LAUNCHES["transpconv2_rows"]
    got = rc.transpconv2_rows(x, w, b, out_dtype=out_dtype, out=buf[..., :cout])
    torch.cuda.synchronize()
    assert rc.LAUNCHES["transpconv2_rows"] == before + 1
    assert got.data_ptr() == buf.data_ptr()
    yr = rc.transpconv2_rows_plain(x, w, b, out_dtype=out_dtype)
    torch.testing.assert_close(buf[..., :cout].float(), yr.float(), rtol=2e-2, atol=2e-2)
    bits = torch.int32 if out_f32 else torch.int16
    assert torch.equal(buf[..., cout:].contiguous().view(bits), rest.view(bits))


def test_conv_kernel_into_a_concat_slice(cuda):
    """K1 writes its output into the last channels of the concat."""
    rng = np.random.default_rng(3)
    x = torch.tensor(rng.normal(size=(1, 7, 9, 20, 16)), dtype=torch.bfloat16, device=cuda)
    w = torch.tensor(rng.normal(size=(3, 3, 3, 16, 32)) * 0.2, dtype=torch.float32,
                     device=cuda)
    norm = _norm(rng, 1, 16, cuda)
    cat = torch.full((1, 7, 9, 20, 64), 3.0, dtype=torch.bfloat16, device=cuda)
    y, s = rc.conv3d_rows(x, norm, w, None, slope=0.01, out=cat[..., 32:])
    torch.cuda.synchronize()
    yr, sr = rc.conv3d_rows_plain(x, norm, w, None, slope=0.01)
    assert y.data_ptr() == cat[..., 32:].data_ptr()
    torch.testing.assert_close(cat[..., 32:].float(), yr.float(), rtol=2e-2, atol=2e-2)
    assert bool((cat[..., :32] == 3.0).all()) and _rel_sums(s, sr) < 1e-2


def test_cuda_tensors_never_take_the_plain_route(cuda, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("plain version called for a CUDA tensor")

    for name in ("conv3d_rows_plain", "conv3d_rows_stride2_plain",
                 "transpconv2_rows_plain", "_plain_conv", "_conv_plain"):
        monkeypatch.setattr(rc, name, refuse)
    x = torch.randn(1, 6, 5, 7, 32, device=cuda).to(torch.bfloat16)
    w3 = torch.randn(3, 3, 3, 32, 64, device=cuda) * 0.1
    w2 = torch.randn(2, 2, 2, 32, 16, device=cuda) * 0.1
    before = dict(rc.LAUNCHES)
    y, _ = rc.conv3d_rows_stride2(x, rc.identity_normact(32, cuda), w3, None)
    up = rc.transpconv2_rows(x, w2, torch.zeros(16, device=cuda))
    packed = rc.pack_transp(w2, None)
    up2 = rc.transpconv2_rows(x, None, w_packed=packed)
    torch.cuda.synchronize()
    assert rc.LAUNCHES["conv3d_rows_stride2"] == before["conv3d_rows_stride2"] + 1
    assert rc.LAUNCHES["transpconv2_rows"] == before["transpconv2_rows"] + 2
    assert y.shape == (1, 3, 3, 4, 64) and torch.equal(up, up2)
    with pytest.raises(ValueError):
        rc.conv3d_rows_stride2(torch.zeros(1, 4, 4, 4, 80, device=cuda, dtype=torch.bfloat16),
                               rc.identity_normact(80, cuda),
                               torch.zeros(3, 3, 3, 80, 16, device=cuda), None)


def test_composite_forward_on_the_kernels_matches_plain(cuda):
    """The composite forward (decoder concat built in place) on the kernels
    against the same forward on the plain versions, at a small width."""
    from boa_tpu_torch.models.unet import ArchConfig, PlainConvUNet, cast_model

    cfg = ArchConfig(n_stages=3, features_per_stage=(16, 32, 64),
                     kernel_sizes=((3, 3, 3),) * 3, strides=((1, 1, 1),) + ((2, 2, 2),) * 2,
                     n_conv_per_stage=(2, 2, 2), n_conv_per_stage_decoder=(2, 2), num_classes=5)
    torch.manual_seed(0)
    model = cast_model(PlainConvUNet(cfg, device=cuda).eval(), torch.bfloat16)
    x = torch.randn(2, 24, 20, 32, 1, device=cuda).to(torch.bfloat16)
    with torch.no_grad():
        rc.reset_launches()
        got = model(x, rc.KERNELS).float()
        assert dict(rc.LAUNCHES) == {"conv3d_rows": 4, "conv3d_rows_stride2": 1,
                                     "transpconv2_rows": 1}
        ref = model(x, rc.PLAIN).float()
    assert got.shape == (2, 24, 20, 32, 5) and bool(torch.isfinite(got).all())
    assert float((got.argmax(-1) == ref.argmax(-1)).float().mean()) > 0.99


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


# ---------------------------------------------------------------------------
# K5: the wide-channel fused conv of boa_tpu_torch/ops/pallas_conv.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(12, 10, 16), (4, 4, 4)])
@pytest.mark.parametrize("cout", [16, 32, 320])
@pytest.mark.parametrize("cin", [1, 3, 32, 640])
def test_in_act_kernel_matches_plain(cuda, cin, cout, shape):
    """bf16 and fp32 outputs, identity and normalized input."""
    from boa_tpu_torch.ops import pallas_conv as pc

    rng = np.random.default_rng(cin * 1000 + cout + shape[0])
    x = torch.tensor(rng.normal(size=shape + (cin,)) * 2 + 0.3,
                     dtype=torch.bfloat16, device=cuda)
    w = torch.tensor(rng.normal(size=(3, 3, 3, cin, cout)) / np.sqrt(27 * cin),
                     dtype=torch.float32, device=cuda)
    b = torch.tensor(rng.normal(size=cout) * 0.1, dtype=torch.float32, device=cuda)
    normed = _norm(rng, 1, cin, cuda)
    normed = normed._replace(mean=normed.mean[0], inv_std=normed.inv_std[0])
    for norm, slope in ((pc.identity_normact(cin, cuda), 1.0), (normed, 0.01)):
        for out_dtype in (torch.bfloat16, torch.float32):
            before = pc.LAUNCHES["conv3d_in_act"]
            y, s = pc.conv3d_in_act(x, norm, w, b, slope=slope, out_dtype=out_dtype)
            torch.cuda.synchronize()
            assert pc.LAUNCHES["conv3d_in_act"] == before + 1
            yr, sr = pc.conv3d_in_act_plain(x, norm, w, b, slope=slope,
                                            out_dtype=out_dtype)
            assert y.shape == yr.shape == shape + (cout,) and y.dtype == out_dtype
            torch.testing.assert_close(y.float(), yr.float(), rtol=2e-2, atol=2e-2)
            assert float((s - sr).abs().max() / sr[1].abs().max().clamp_min(1e-6)) < 1e-2


def test_in_act_cuda_tensor_never_takes_the_plain_route(cuda, monkeypatch):
    from boa_tpu_torch.ops import pallas_conv as pc

    def refuse(*a, **k):
        raise AssertionError("plain version called for a CUDA tensor")

    monkeypatch.setattr(pc, "conv3d_in_act_plain", refuse)
    monkeypatch.setattr(pc, "_conv_plain", refuse)
    x = torch.randn(6, 5, 7, 24, device=cuda).to(torch.bfloat16)
    w = torch.randn(3, 3, 3, 24, 40, device=cuda) * 0.1
    before = pc.LAUNCHES["conv3d_in_act"]
    y, s = pc.conv3d_in_act(x, pc.identity_normact(24, cuda), w, None)
    y2, _ = pc.conv3d_in_act(x, pc.identity_normact(24, cuda), None, None,
                             w_packed=pc.pack_in_act_weights(w), cin=24, cout=40)
    torch.cuda.synchronize()
    assert pc.LAUNCHES["conv3d_in_act"] == before + 2
    assert y.shape == (6, 5, 7, 40) and torch.equal(y, y2)
    with pytest.raises(ValueError):
        pc.conv3d_in_act(x[..., :3], pc.identity_normact(3, cuda), w, None)


def test_fused_forward_on_the_kernel_matches_plain(cuda):
    """The fused U-Net forward on the kernel against the same forward on the
    plain version, bf16, at a small width and a ragged tile."""
    from boa_tpu_torch.models.unet import ArchConfig, PlainConvUNet, cast_model
    from boa_tpu_torch.models.unet_fused import pack_unet_params, unet_forward_fused
    from boa_tpu_torch.ops import pallas_conv as pc

    n = 4
    cfg = ArchConfig(n_stages=n, features_per_stage=(16, 32, 64, 96),
                     kernel_sizes=((3, 3, 3),) * n,
                     strides=((1, 1, 1),) + ((2, 2, 2),) * (n - 1),
                     n_conv_per_stage=(2,) * n, n_conv_per_stage_decoder=(2,) * (n - 1),
                     num_classes=5)
    torch.manual_seed(0)
    model = cast_model(PlainConvUNet(cfg, device=cuda).eval(), torch.bfloat16)
    packed = pack_unet_params(model)
    x = torch.randn(24, 32, 16, 1, device=cuda).to(torch.bfloat16)
    pc.reset_launches()
    got = unet_forward_fused(model, packed, x).float()
    assert pc.LAUNCHES["conv3d_in_act"] == 2 + 3 + 2 * (n - 1)
    ref = unet_forward_fused(model, packed, x, conv=pc.conv3d_in_act_plain).float()
    assert got.shape == (24, 32, 16, 5) and bool(torch.isfinite(got).all())
    assert float((got.argmax(-1) == ref.argmax(-1)).float().mean()) > 0.99
