"""The port's U-Net and weight loading against the reference (boa_tpu).

* the eager float32 forward against `unet_forward` at rtol = atol = 1e-4
  (the reference's own bar, tests/test_unet_parity.py), X != Y != Z;
* the bf16 row-conv composite (plain versions on the CPU) against the
  reference's `_rowconv_forward` (BOA_ROWCONV=interpret) on the arch and
  tile of tests/test_rowconv.py, argmax agreement > 0.99;
* both loaders give identical parameters from one store folder.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from boa_tpu.models import unet as ju
from boa_tpu.weights import convert as jcv
from boa_tpu.weights import store as jstore
from boa_tpu_torch.models.unet import ArchConfig, PlainConvUNet, unet_infer
from boa_tpu_torch.weights import convert as cv
from boa_tpu_torch.weights import store as tstore

_ARCHS = {
    "plain4": dict(n_stages=4, features_per_stage=(8, 16, 32, 64),
                   kernel_sizes=((3, 3, 3),) * 4,
                   strides=((1, 1, 1), (2, 2, 2), (2, 2, 2), (2, 2, 2)),
                   n_conv_per_stage=(2, 2, 2, 2), n_conv_per_stage_decoder=(2, 2, 2),
                   num_classes=5),
    "aniso3": dict(n_stages=3, features_per_stage=(8, 16, 32),
                   kernel_sizes=((3, 3, 1), (3, 3, 3), (3, 3, 3)),
                   strides=((1, 1, 1), (2, 2, 1), (2, 2, 2)),
                   n_conv_per_stage=(2, 2, 2), n_conv_per_stage_decoder=(2, 2),
                   num_classes=4, input_channels=2),
}


def _pair(kw, seed):
    params = ju.init_unet(jax.random.PRNGKey(seed), ju.ArchConfig(**kw))
    model = cv.params_from_numpy(jax.tree.map(np.asarray, params),
                                 ArchConfig(**kw), "cpu")
    return params, model


@pytest.mark.parametrize("arch,shape", [("plain4", (1, 16, 24, 8)),
                                        ("aniso3", (2, 12, 8, 20))])
def test_eager_fp32_forward_matches_reference(arch, shape):
    kw = _ARCHS[arch]
    params, model = _pair(kw, 1)
    x = np.random.default_rng(0).normal(
        size=shape + (kw.get("input_channels", 1),)).astype(np.float32)
    ref = np.asarray(ju.unet_forward(params, jnp.asarray(x), ju.ArchConfig(**kw)))
    got = unet_infer(model, torch.from_numpy(x), torch.float32).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_bf16_composite_matches_reference_rowconv_forward(monkeypatch):
    kw = dict(n_stages=3, features_per_stage=(8, 16, 32),
              kernel_sizes=((3, 3, 3),) * 3,
              strides=((1, 1, 1), (2, 2, 2), (2, 2, 2)),
              n_conv_per_stage=(2, 2, 2), n_conv_per_stage_decoder=(2, 2),
              num_classes=5)
    params, model = _pair(kw, 3)
    x = np.random.default_rng(1).normal(size=(1, 8, 128, 8, 1)).astype(np.float32)
    monkeypatch.setenv("BOA_ROWCONV", "interpret")
    ref = np.asarray(ju.unet_infer(params, jnp.asarray(x), ju.ArchConfig(**kw),
                                   jnp.bfloat16))
    got = unet_infer(model, torch.from_numpy(x), torch.bfloat16).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0.06, atol=0.06)
    agree = (got.argmax(-1) == ref.argmax(-1)).mean()
    assert agree > 0.99, f"argmax agreement {agree}"


def test_composite_is_chosen_by_dtype_and_geometry():
    from boa_tpu_torch.ops import rowconv as rc

    kw = dict(_ARCHS["plain4"])
    model = PlainConvUNet(ArchConfig(**kw), device="cpu").to(torch.bfloat16)
    rc.reset_launches()  # the plain versions count nothing: they launch nothing
    calls = []

    def spy(fn):
        def wrapped(*a, **k):
            calls.append(fn.__name__)
            return fn(*a, **k)
        return wrapped

    ops = rc.RowOps(*(spy(f) for f in rc.KERNELS))
    x = torch.zeros((1, 16, 24, 8, 1), dtype=torch.bfloat16)
    model(x, ops)
    assert calls == ["conv3d_rows", "conv3d_rows", "conv3d_rows_stride2",
                     "transpconv2_rows", "conv3d_rows", "conv3d_rows"]
    calls.clear()
    model.float()(x.float(), ops)   # float32: eager
    aniso = PlainConvUNet(ArchConfig(**_ARCHS["aniso3"]), device="cpu").to(torch.bfloat16)
    aniso(torch.zeros((1, 12, 8, 20, 2), dtype=torch.bfloat16), ops)  # 3x3x1 stem: eager
    wide = PlainConvUNet(ArchConfig(**dict(kw, features_per_stage=(16, 128, 32, 64))),
                         device="cpu").to(torch.bfloat16)
    wide(x, ops)   # stage 1 wider than the conv kernel's cout: eager
    assert calls == [] and sum(rc.LAUNCHES.values()) == 0


def test_composite_packs_weights_once_and_again_after_an_update():
    """The composite caches its packed weights on the model: equal to packing
    per call (the stride-1 layers for `conv3d_rows`, the input conv with its
    taps folded into K; the stride-2 layer for `conv3d_rows_stride2`),
    reused while the parameters stay, packed again after an in-place
    update."""
    from boa_tpu_torch.models.unet import _row_packs, _wcl
    from boa_tpu_torch.ops import rowconv as rc

    model = PlainConvUNet(ArchConfig(**_ARCHS["plain4"]), device="cpu").to(torch.bfloat16)
    packs = _row_packs(model)
    assert _row_packs(model) is packs
    st = model.decoder[-1]
    stride1 = (model.encoder[0][0].conv, model.encoder[0][1].conv, st.convs[0].conv,
               st.convs[1].conv)
    for got, conv in zip(packs.enc0 + packs.dec, stride1):
        fresh = rc.pack_rows(_wcl(conv), conv.bias)
        assert got.kind == "conv3d_rows" and (got.cin, got.cout) == (fresh.cin, fresh.cout)
        assert torch.equal(got.w, fresh.w) and torch.equal(got.bias, fresh.bias)
    assert packs.enc0[0].cin == 1 and packs.enc0[0].w.numel() == 32 * 32  # 27 taps in K = 32
    conv = model.encoder[1][0].conv
    fresh = rc.pack_conv(_wcl(conv), conv.bias)
    assert packs.down.kind == "conv3d_rows_stride2"
    assert torch.equal(packs.down.w, fresh.w) and torch.equal(packs.down.bias, fresh.bias)
    up = rc.pack_transp(model.decoder[-1].transp.weight.permute(2, 3, 4, 0, 1),
                        model.decoder[-1].transp.bias)
    assert torch.equal(packs.up.w, up.w) and torch.equal(packs.up.bias, up.bias)
    with torch.no_grad():
        conv.weight.add_(1.0)
    again = _row_packs(model)
    assert again is not packs
    fresh = rc.pack_conv(_wcl(conv), conv.bias)
    assert torch.equal(again.down.w, fresh.w) and not torch.equal(again.down.w, packs.down.w)
    x = torch.randn(1, 16, 24, 8, 1).to(torch.bfloat16)
    with torch.no_grad():
        model(x)
    assert _row_packs(model) is again


def test_loaders_give_identical_parameters(tmp_path):
    mdir = jstore.create_synthetic_model(tmp_path, 298, "t", num_classes=4,
                                         patch_size=(16, 16, 16),
                                         features=(8, 16, 32))
    npz = mdir / "fold_0" / "checkpoint_final.npz"
    from boa_tpu.plans.plans import ModelPlans as JPlans
    from boa_tpu_torch.plans.plans import ModelPlans

    jcfg = JPlans.from_model_folder(mdir).arch_config()
    cfg = ModelPlans.from_model_folder(mdir).arch_config()
    assert dataclass_fields(cfg) == dataclass_fields(jcfg)
    ref = jcv.load_params_npz(npz, jcfg)
    got = cv.load_params_npz(npz)
    flat_ref = jax.tree_util.tree_flatten_with_path(ref)[0]
    flat_got = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [k for k, _ in flat_ref] == [k for k, _ in flat_got]
    for (_, a), (_, b) in zip(flat_ref, flat_got):
        np.testing.assert_array_equal(np.asarray(a), b)
    m1 = cv.params_from_numpy(got, cfg, "cpu")
    m2 = cv.params_from_numpy(jax.tree.map(np.asarray, ref), cfg, "cpu")
    for (k1, v1), (k2, v2) in zip(m1.state_dict().items(), m2.state_dict().items()):
        assert k1 == k2 and torch.equal(v1, v2)
    # round trip through the port's writer, and its synthetic folder reads in
    # the reference
    cv.save_params_npz(got, tmp_path / "rt.npz")
    again = cv.load_params_npz(tmp_path / "rt.npz")
    for (_, a), (_, b) in zip(flat_got, jax.tree_util.tree_flatten_with_path(again)[0]):
        np.testing.assert_array_equal(a, b)
    tdir = tstore.create_synthetic_model(tmp_path / "port", 297, "p", num_classes=3,
                                         patch_size=(16, 16, 16), features=(4, 8))
    plans_j, params_j = jstore.ModelStore(tmp_path / "port").load(297, model="3d_fullres")
    assert plans_j.arch_config().features_per_stage == (4, 8)
    assert (tdir / "fold_0" / "checkpoint_final.npz").exists() and len(params_j) == 1


def dataclass_fields(cfg):
    import dataclasses

    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
