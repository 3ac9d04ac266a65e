"""The port's wide-channel fused conv (K5, plain version on the CPU) and its
fused U-Net forward against the reference (boa_tpu/ops/pallas_conv.py and
boa_tpu/models/unet_fused.py, Pallas in interpret mode on the CPU).

Inputs are made with numpy seeds and handed to both sides. Bars:
* conv3d_in_act: both sides round x and w to bf16 at the same points and
  accumulate in fp32, so max |diff| <= 1e-3 * max |ref| and the sums within
  1e-3 of the largest sum of squares;
* fused forward on parameters pre-rounded to bf16 (so the reference's fp32
  kernel weights equal the port's bf16 ones): max |diff| <= 1e-2 * logit
  scale, argmax agreement > 0.995;
* fused forward on raw fp32 parameters against the reference's fp32
  `unet_forward`: the reference's own bar (tests/test_unet_fused.py),
  5 % of the logit scale and argmax agreement > 0.98.
The card-only kernel-vs-plain checks live in tests/test_torch_kernels.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from boa_tpu.models import unet as ju
from boa_tpu.models import unet_fused as juf
from boa_tpu.ops import pallas_conv as jpc
from boa_tpu_torch.models.unet import ArchConfig
from boa_tpu_torch.models.unet_fused import pack_unet_params, unet_forward_fused
from boa_tpu_torch.ops import pallas_conv as pc
from boa_tpu_torch.weights.convert import params_from_numpy


def _check_conv(y, s, yj, sj):
    yj, sj = np.asarray(yj), np.asarray(sj)
    assert y.shape == yj.shape and s.shape == sj.shape
    assert np.abs(y.numpy() - yj).max() <= 1e-3 * np.abs(yj).max()
    assert np.abs(s.numpy() - sj).max() <= 1e-3 * np.abs(sj[1]).max()


def _conv_both(x, w, b, nd, slope):
    """The reference kernel, the port's wrapper (plain on the CPU) and the
    wrapper on pre-packed weights, all with fp32 outputs."""
    if nd is None:
        nj, nt = jpc.identity_normact(x.shape[-1]), pc.identity_normact(x.shape[-1])
    else:
        nj = jpc.NormAct(**{k: jnp.asarray(v) for k, v in nd.items()}, slope=slope)
        nt = pc.NormAct(**{k: torch.from_numpy(v) for k, v in nd.items()}, slope=slope)
    yj, sj = jpc.conv3d_in_act(jnp.asarray(x), nj, jnp.asarray(w), jnp.asarray(b),
                               slope=slope, out_dtype=jnp.float32, interpret=True)
    xt, wt, bt = torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b)
    y, s = pc.conv3d_in_act(xt, nt, wt, bt, slope=slope, out_dtype=torch.float32)
    _check_conv(y, s, yj, sj)
    y, s = pc.conv3d_in_act(xt, nt, None, bt, slope=slope, out_dtype=torch.float32,
                            w_packed=pc.pack_in_act_weights(wt), cin=w.shape[3],
                            cout=w.shape[4])
    _check_conv(y, s, yj, sj)


@pytest.mark.parametrize("shape,cin,cout", [
    ((12, 10, 16), 8, 16),
    ((16, 12, 16), 32, 32),
    ((8, 8, 8), 64, 64),
    ((6, 6, 4), 3, 32),       # odd cin
])
def test_conv3d_in_act_matches_reference(shape, cin, cout):
    rng = np.random.default_rng(42 + cin + cout)
    x = rng.normal(size=(*shape, cin)).astype(np.float32)
    w = (rng.normal(size=(3, 3, 3, cin, cout)) * 0.1).astype(np.float32)
    b = (rng.normal(size=cout) * 0.1).astype(np.float32)
    _conv_both(x, w, b, None, 1.0)


def test_conv3d_in_act_normalized_input_matches_reference():
    rng = np.random.default_rng(7)
    shape, cin, cout = (10, 8, 12), 16, 16
    x = rng.normal(size=(*shape, cin)).astype(np.float32)
    w = (rng.normal(size=(3, 3, 3, cin, cout)) * 0.1).astype(np.float32)
    b = (rng.normal(size=cout) * 0.1).astype(np.float32)
    var = rng.uniform(0.5, 2.0, cin)
    nd = {"mean": rng.normal(size=cin), "inv_std": 1.0 / np.sqrt(var + 1e-5),
          "gamma": rng.normal(size=cin), "beta": rng.normal(size=cin)}
    nd = {k: v.astype(np.float32) for k, v in nd.items()}
    _conv_both(x, w, b, nd, 0.01)


@pytest.mark.parametrize("cin,cout", [(3, 16), (40, 80), (64, 320)])
def test_pack_in_act_weights_fragment_order(cin, cout):
    """Each lane's 16 bytes hold the B values the kernel's mma reads there
    (the layout documented in csrc/conv_in_act.cu), and unpacking inverts."""
    ck, nch, bn, cout_p = pc._plan(cin, cout)
    w = torch.randn(3, 3, 3, cin, cout, generator=torch.Generator().manual_seed(cin))
    wp = pc.pack_in_act_weights(w)
    pk = wp.float().reshape(cout_p // bn, nch, 27, ck // 16, bn // 16, 32, 8)
    got = torch.empty(27, nch * ck, cout_p)
    for lane in range(32):
        g, t = divmod(lane, 4)
        for j in range(8):
            q, h, e = j // 4, (j // 2) % 2, j % 2
            for nb in range(cout_p // bn):
                for p in range(bn // 16):
                    for c in range(nch):
                        for s in range(ck // 16):
                            got[:, c * ck + s * 16 + 8 * h + 2 * t + e,
                                nb * bn + p * 16 + 8 * q + g] = pk[nb, c, :, s, p, lane, j]
    want = torch.zeros(27, nch * ck, cout_p)
    want[:, :cin, :cout] = w.to(torch.bfloat16).float().reshape(27, cin, cout)
    assert torch.equal(got, want)
    assert torch.equal(pc.unpack_in_act_weights(wp, cin, cout).float(),
                       w.to(torch.bfloat16).float())


def _kw(feats=(8, 16, 32), n_cls=4):
    n = len(feats)
    return dict(n_stages=n, features_per_stage=tuple(feats),
                kernel_sizes=((3, 3, 3),) * n,
                strides=((1, 1, 1),) + ((2, 2, 2),) * (n - 1),
                n_conv_per_stage=(2,) * n, n_conv_per_stage_decoder=(2,) * (n - 1),
                num_classes=n_cls, input_channels=1)


def _params(kw, seed, to_bf16):
    params = jax.tree.map(np.asarray, ju.init_unet(jax.random.PRNGKey(seed),
                                                   ju.ArchConfig(**kw)))
    if to_bf16:
        params = jax.tree.map(lambda a: np.asarray(
            jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32)), params)
    return params, params_from_numpy(params, ArchConfig(**kw), "cpu")


def test_pack_unet_params_eligibility():
    kw = _kw(feats=(4, 8))
    _, model = _params(kw, 1, False)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    packed = pack_unet_params(model)
    # stride-1 encoder blocks packed; stride-2 first blocks of deeper stages not
    assert packed["encoder"][0][0] is not None
    assert packed["encoder"][0][1] is not None
    assert packed["encoder"][1][0] is None  # stride-2 downsample
    assert packed["encoder"][1][1] is not None
    assert packed["decoder"][0]["convs"][0] is not None
    assert packed["encoder"][0][0].dtype == torch.bfloat16
    # the model is untouched
    after = model.state_dict()
    assert before.keys() == after.keys()
    assert all(torch.equal(before[k], after[k]) for k in before)


@pytest.mark.parametrize("shape", [(16, 16, 16), (12, 20, 16)])
def test_fused_forward_matches_reference_fused(shape):
    kw = _kw()
    params, model = _params(kw, 0, True)
    x = np.random.default_rng(5).normal(size=shape + (1,)).astype(np.float32)
    cfg = ju.ArchConfig(**kw)
    ref = np.asarray(juf.unet_forward_fused(juf.pack_unet_params(params, cfg),
                                            jnp.asarray(x), cfg, interpret=True))
    pc.reset_launches()
    got = unet_forward_fused(model, pack_unet_params(model), torch.from_numpy(x)).numpy()
    assert pc.LAUNCHES["conv3d_in_act"] == 0  # CPU tensors take the plain version
    assert got.shape == ref.shape == shape + (4,)
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() <= 1e-2 * scale
    assert (got.argmax(-1) == ref.argmax(-1)).mean() > 0.995


@pytest.mark.parametrize("shape", [(16, 16, 16), (12, 20, 16)])
def test_fused_forward_matches_reference_forward(shape):
    kw = _kw()
    params, model = _params(kw, 0, False)
    x = np.random.default_rng(6).normal(size=shape + (1,)).astype(np.float32)
    ref = np.asarray(ju.unet_forward(params, jnp.asarray(x)[None], ju.ArchConfig(**kw))[0])
    got = unet_forward_fused(model, pack_unet_params(model), torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() <= 0.05 * scale
    assert (got.argmax(-1) == ref.argmax(-1)).mean() > 0.98
