"""The port's other U-Net forwards against the reference (boa_tpu) and the
torch oracle (tests/torch_mirror.TorchUNet): residual encoders, 2d
configurations (per-slice instance norm), anisotropic strides and the
deep-supervision heads, in float32 at rtol = atol = 1e-4 (the bar of
tests/test_unet_parity.py), at small widths (3 stages, 4 -> 16)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from boa_tpu.models import unet as ju
from boa_tpu.plans import plans as jplans
from boa_tpu_torch.models import unet as tu
from boa_tpu_torch.plans import plans as tplans
from boa_tpu_torch.weights import convert as cv
from boa_tpu_torch.weights.store import init_params_numpy

from tests.torch_mirror import TorchUNet

_BASE = dict(n_stages=3, features_per_stage=(4, 8, 16),
             kernel_sizes=((3, 3, 3),) * 3,
             strides=((1, 1, 1), (2, 2, 2), (2, 2, 2)),
             n_conv_per_stage=(2, 2, 2), n_conv_per_stage_decoder=(2, 2),
             num_classes=3)
ARCHS = {
    "residual": dict(_BASE, residual_encoder=True, n_blocks_per_stage=(1, 2, 2)),
    "residual_1conv_decoder": dict(_BASE, residual_encoder=True,
                                   n_blocks_per_stage=(1, 3, 2),
                                   n_conv_per_stage_decoder=(1, 1),
                                   input_channels=2),
    "aniso": dict(_BASE, kernel_sizes=((3, 3, 1), (3, 3, 3), (3, 3, 3)),
                  strides=((1, 1, 1), (2, 2, 1), (2, 2, 2)), num_classes=4),
    "residual_aniso": dict(_BASE, residual_encoder=True, n_blocks_per_stage=(1, 1, 2),
                           kernel_sizes=((3, 3, 1), (3, 3, 3), (3, 3, 3)),
                           strides=((1, 1, 1), (2, 2, 1), (2, 2, 2))),
    "two_d": dict(_BASE, kernel_sizes=((3, 3, 1),) * 3,
                  strides=((1, 1, 1), (2, 2, 1), (2, 2, 1)), two_d=True),
    "residual_two_d": dict(_BASE, kernel_sizes=((3, 3, 1),) * 3,
                           strides=((1, 1, 1), (2, 2, 1), (2, 2, 1)), two_d=True,
                           residual_encoder=True, n_blocks_per_stage=(1, 2, 2)),
}
SHAPES = {"aniso": (16, 16, 8), "residual_aniso": (16, 12, 8), "two_d": (16, 16, 5),
          "residual_two_d": (12, 16, 4)}


def _pair(name, seed=0, **extra):
    kw = dict(ARCHS[name], **extra)
    params = init_params_numpy(tu.ArchConfig(**kw), seed)
    return kw, params, cv.params_from_numpy(params, tu.ArchConfig(**kw), "cpu")


def _input(kw, shape, seed=1):
    return np.random.default_rng(seed).normal(
        size=(1,) + shape + (kw.get("input_channels", 1),)).astype(np.float32)


def _mirror(kw, params, deep_supervision=False):
    """TorchUNet holding `params` (its state dict through the port's
    real-format writer, whose keys are the oracle's)."""
    from boa_tpu_torch.testing.nnunet_checkpoint import network_weights

    net = TorchUNet(ju.ArchConfig(**kw), deep_supervision=deep_supervision).eval()
    net.load_state_dict(network_weights(params, tu.ArchConfig(**kw)))
    return net


def _mirror_run(net, x, per_slice: bool):
    """The oracle on (1, X, Y, Z, C): the whole volume, or slice by slice
    (InstanceNorm3d on one slice is InstanceNorm2d)."""
    xt = torch.from_numpy(x).permute(0, 4, 1, 2, 3)
    with torch.no_grad():
        if not per_slice:
            out = net(xt)
            return [o.permute(0, 2, 3, 4, 1).numpy() for o in out] \
                if isinstance(out, list) else out.permute(0, 2, 3, 4, 1).numpy()
        outs = [net(xt[..., z:z + 1]) for z in range(xt.shape[-1])]
        return torch.cat(outs, dim=-1).permute(0, 2, 3, 4, 1).numpy()


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_fp32_forward_matches_reference_and_oracle(name):
    kw, params, model = _pair(name)
    x = _input(kw, SHAPES.get(name, (16, 16, 16)))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    ref = np.asarray(ju.unet_forward(jax.tree.map(jnp.asarray, params),
                                     jnp.asarray(x), ju.ArchConfig(**kw)))
    assert got.shape == ref.shape == x.shape[:4] + (kw["num_classes"],)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    oracle = _mirror_run(_mirror(kw, params), x, per_slice=kw.get("two_d", False))
    np.testing.assert_allclose(got, oracle, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", ["two_d", "residual_two_d"])
def test_two_d_is_per_slice(name):
    """A 2d net on a stack equals the same net on each slice alone, and the
    same weights as a 3d config (volume statistics) give another output."""
    kw, params, model = _pair(name, seed=2)
    x = torch.from_numpy(_input(kw, SHAPES[name], seed=3))
    with torch.no_grad():
        stacked = model(x)
        for z in range(x.shape[3]):
            single = model(x[:, :, :, z:z + 1])
            np.testing.assert_allclose(stacked[:, :, :, z:z + 1].numpy(), single.numpy(),
                                       rtol=2e-4, atol=2e-5)
        as3d = cv.params_from_numpy(params, tu.ArchConfig(**dict(kw, two_d=False)), "cpu")
        assert not np.allclose(as3d(x).numpy(), stacked.numpy(), atol=1e-4)


@pytest.mark.parametrize("name", ["residual", "aniso", "two_d"])
def test_deep_supervision_heads(name):
    """`all_heads=True` on a deep-supervision config: one head per decoder
    stage, highest resolution first, each as the reference's and the
    oracle's; without the flag (or the config) only the last head."""
    kw, params, model = _pair(name, seed=4, deep_supervision=True)
    x = _input(kw, SHAPES.get(name, (16, 16, 16)), seed=5)
    with torch.no_grad():
        heads = model(torch.from_numpy(x), all_heads=True)
        last = model(torch.from_numpy(x))
    refs = ju.unet_forward(jax.tree.map(jnp.asarray, params), jnp.asarray(x),
                           ju.ArchConfig(**kw), all_heads=True)
    assert isinstance(heads, list) and len(heads) == len(refs) == kw["n_stages"] - 1
    for h, r in zip(heads, refs):
        np.testing.assert_allclose(h.numpy(), np.asarray(r), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(heads[0].numpy(), last.numpy())
    assert heads[1].shape[1] < heads[0].shape[1]
    if not kw.get("two_d"):
        oracle = _mirror_run(_mirror(kw, params, deep_supervision=True), x, False)
        for h, o in zip(heads, oracle):
            np.testing.assert_allclose(h.numpy(), o, rtol=1e-4, atol=1e-4)
    plain = cv.params_from_numpy(params, tu.ArchConfig(**dict(kw, deep_supervision=False)),
                                 "cpu")
    with torch.no_grad():
        out = plain(torch.from_numpy(x), all_heads=True)
    assert isinstance(out, torch.Tensor)
    np.testing.assert_array_equal(out.numpy(), last.numpy())


_ROWCONV_GEOMETRY = dict(n_stages=3, features_per_stage=(8, 16, 32),
                         kernel_sizes=((3, 3, 3),) * 3,
                         strides=((1, 1, 1), (2, 2, 2), (2, 2, 2)),
                         n_conv_per_stage=(2, 2, 2), n_conv_per_stage_decoder=(2, 2),
                         num_classes=4)


@pytest.mark.parametrize("change", [dict(), dict(residual_encoder=True,
                                                 n_blocks_per_stage=(1, 1, 1)),
                                    dict(two_d=True)])
def test_rowconv_eligibility_refuses_residual_and_2d(change):
    """On the composite's geometry, only the plain 3d config takes the
    row-conv kernels, as the reference's rule; the bf16 forward of the
    others is the eager one, bit for bit."""
    cfg = tu.ArchConfig(**dict(_ROWCONV_GEOMETRY, **change))
    shape = (1, 16, 16, 16, 1)
    assert tu._rowconv_eligible(cfg, shape) == (not change)
    assert ju._rowconv_eligible(ju.ArchConfig(**dict(_ROWCONV_GEOMETRY, **change)),
                                (1, 16, 128, 16, 1)) == (not change)
    if change:
        model = tu.cast_model(cv.params_from_numpy(init_params_numpy(cfg, 0), cfg, "cpu"),
                              torch.bfloat16)
        x = torch.from_numpy(_input(dict(_ROWCONV_GEOMETRY), (16, 16, 16))).bfloat16()
        with torch.no_grad():
            assert torch.equal(model(x), model.forward_eager(x))


def test_network_classes():
    res = tu.ArchConfig(**ARCHS["residual"])
    assert isinstance(tu.make_unet(res, "cpu"), tu.ResidualEncoderUNet)
    assert type(tu.make_unet(tu.ArchConfig(**ARCHS["aniso"]), "cpu")) is tu.PlainConvUNet
    with pytest.raises(ValueError, match="make_unet"):
        tu.PlainConvUNet(res, "cpu")
    with pytest.raises(ValueError, match="skip"):
        params = init_params_numpy(res, 0)
        params["encoder"][1][0].pop("skip")
        cv.params_from_numpy(params, res, "cpu")


def _plans_doc(arch_kwargs, class_name, patch, spacing):
    return {"configurations": {"c": {
        "architecture": {"network_class_name": class_name, "arch_kwargs": arch_kwargs},
        "patch_size": patch, "spacing": spacing}},
        "foreground_intensity_properties_per_channel": {}}


@pytest.mark.parametrize("kind", ["resenc", "two_d"])
@pytest.mark.parametrize("ds", [False, True])
def test_arch_config_from_plans_matches_reference(kind, ds):
    if kind == "resenc":
        kw = {"n_stages": 4, "features_per_stage": [32, 64, 128, 256],
              "kernel_sizes": [[3, 3, 3]] * 4, "strides": [[1, 1, 1]] + [[2, 2, 2]] * 3,
              "n_blocks_per_stage": [1, 3, 4, 6], "n_conv_per_stage_decoder": [1, 1, 1],
              "conv_bias": True, "norm_op_kwargs": {"eps": 1e-5, "affine": True}}
        doc = _plans_doc(kw, "dynamic_network_architectures.architectures.residual_unet."
                         "ResidualEncoderUNet", [128, 128, 128], [1.5, 1.5, 1.5])
    else:
        kw = {"n_stages": 3, "features_per_stage": [32, 64, 128],
              "kernel_sizes": [[3, 3]] * 3, "strides": [[1, 1], [2, 2], [2, 2]],
              "n_conv_per_stage": [2, 2, 2], "n_conv_per_stage_decoder": [2, 2]}
        doc = _plans_doc(kw, "dynamic_network_architectures.architectures.unet."
                         "PlainConvUNet", [256, 256], [0.8, 0.8])
    ds_json = {"labels": {"background": 0, "a": 1, "b": 2}, "channel_names": {"0": "CT"}}
    got = tplans.ModelPlans(doc, ds_json, "c").arch_config(deep_supervision=ds)
    want = jplans.ModelPlans(doc, ds_json, "c").arch_config(deep_supervision=ds)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.deep_supervision is ds and got.residual_encoder is (kind == "resenc")
