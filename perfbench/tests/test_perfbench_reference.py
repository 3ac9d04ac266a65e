"""The reference's forward against torch.nn's layers, and each frozen copy
against the port's function it was copied from."""

import numpy as np
import pytest
import torch
import torch.nn as nn

from perfbench import phantom, weights
from perfbench.fronts import totalsegmentator as ts_front
from perfbench.nets import plainconvunet
from perfbench.reference import geometry as geo
from perfbench.reference import unet
from perfbench.tests import tiny


def _nn_forward(params, net, x):
    """The same network from torch.nn modules, loaded leaf by leaf."""
    eps, slope = net["norm_eps"], net["nonlin_slope"]

    def block(p, stride):
        w = unet.conv_weight(p["w"])
        conv = nn.Conv3d(w.shape[1], w.shape[0], tuple(w.shape[2:]), tuple(stride),
                         padding=tuple((k - 1) // 2 for k in w.shape[2:]))
        norm = nn.InstanceNorm3d(w.shape[0], eps=eps, affine=True)
        with torch.no_grad():
            conv.weight.copy_(w)
            conv.bias.copy_(p["b"])
            norm.weight.copy_(p["norm_scale"])
            norm.bias.copy_(p["norm_bias"])
        return nn.Sequential(conv, norm, nn.LeakyReLU(slope))

    skips, h = [], x
    for s, stage in enumerate(params["encoder"]):
        for b, p in enumerate(stage):
            h = block(p, net["strides"][s] if b == 0 else (1, 1, 1))(h)
        skips.append(h)
    y = skips[-1]
    for i, st in enumerate(params["decoder"]):
        w = unet.transp_weight(st["transp"]["w"])
        s = tuple(net["strides"][len(skips) - 1 - i])
        up = nn.ConvTranspose3d(w.shape[0], w.shape[1], s, s)
        with torch.no_grad():
            up.weight.copy_(w)
            up.bias.copy_(st["transp"]["b"])
        y = torch.cat([up(y), skips[len(skips) - 2 - i]], dim=1)
        for p in st["convs"]:
            y = block(p, (1, 1, 1))(y)
    head = params["seg_heads"][-1]
    return nn.functional.conv3d(y, unet.conv_weight(head["w"]), head["b"])


def _params(seed=0, classes=5):
    gen = torch.Generator().manual_seed(seed)
    return weights.make_params(plainconvunet.leaf_specs(tiny.NET, classes), gen, "cpu",
                               {"sd": 3.0, "seed": 7}, 297)


def test_forward_against_torch_nn():
    params = _params()
    x = torch.randn(1, 1, 16, 16, 16, generator=torch.Generator().manual_seed(1))
    with unet.exact_float32(), torch.no_grad():
        got = plainconvunet.forward(params, tiny.NET, x)
        want = _nn_forward(params, tiny.NET, x)
    assert got.shape == (1, 5, 16, 16, 16)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_fp8_control_departs_more_than_bf16():
    params = _params()
    x = torch.randn(1, 1, 16, 16, 16, generator=torch.Generator().manual_seed(2))
    with unet.exact_float32():
        ref = plainconvunet.forward(params, tiny.NET, x)
        low = plainconvunet.forward(params, tiny.NET, x, fp8=True)
        bf = plainconvunet.forward(_map(params, lambda t: t.bfloat16().float()),
                                   tiny.NET, x.bfloat16().float())
    assert (low - ref).abs().max() > 5 * (bf - ref).abs().max()


def test_params_match_the_port_layout():
    from boa_tpu_torch.plans.plans import synthetic_plans
    from boa_tpu_torch.weights.convert import params_from_numpy

    params = _params(classes=7)
    cfg = synthetic_plans(num_classes=7, patch_size=(16, 16, 16),
                          features=tuple(tiny.NET["features_per_stage"])).arch_config()
    model = params_from_numpy(_numpy_tree(params), cfg, "cpu")
    x = torch.randn(1, 1, 16, 16, 16, generator=torch.Generator().manual_seed(3))
    with unet.exact_float32(), torch.no_grad():
        want = plainconvunet.forward(params, tiny.NET, x)
        got = model(x.permute(0, 2, 3, 4, 1)).permute(0, 4, 1, 2, 3)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def _map(node, fn):
    if isinstance(node, dict):
        return {k: _map(v, fn) for k, v in node.items()}
    if isinstance(node, list):
        return [_map(v, fn) for v in node]
    return fn(node)


def _numpy_tree(node):
    if isinstance(node, dict):
        return {k: _numpy_tree(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_numpy_tree(v) for v in node]
    return node.numpy()


@pytest.mark.parametrize("shape,spacing", [((128, 192, 24), (2.0, 2.0, 5.0)),
                                           ((512, 512, 40), (0.8, 0.8, 1.0))])
def test_frozen_copies_equal_the_port(shape, spacing):
    from boa_tpu_torch.io.nifti import NiftiImage, canonical_geometry
    from boa_tpu_torch.ops import cropping, preprocess, resample
    from boa_tpu_torch.testing.anatomy import synth_ct

    ct = phantom.synth_ct(shape, spacing, 10.0, 7)
    assert np.array_equal(phantom.synth_ct(shape, spacing, 0.0, 7),
                          synth_ct(shape, spacing, 0.0, 7))   # the noise is drawn in F order
    aff = np.diag([-spacing[0], -spacing[1], spacing[2], 1.0])
    img = NiftiImage(data=ct, affine=aff)
    _, info = cropping.body_crop_xy(img)
    box = geo.body_crop_xy(ct, spacing)
    assert (box is None) == (info is None)
    if box is not None:
        assert box == (info.x0, info.x1, info.y0, info.y1)
    ornt, _, cshape, zooms = canonical_geometry(img)
    o2, s2, z2 = geo.canonical_geometry(aff, ct.shape)
    assert np.array_equal(ornt, o2) and cshape == s2 and np.allclose(zooms, z2)
    for n_in, n_out in ((40, 13), (13, 40), (85, 171)):
        np.testing.assert_allclose(geo.axis_operator(n_in, n_out, 3),
                                   resample.axis_operator(n_in, n_out, 3, "zoom"), atol=1e-6)
        assert np.array_equal(geo.axis_nearest_indices(n_in, n_out),
                              resample.axis_nearest_indices(n_in, n_out, "zoom"))
    w = (60, 20, 8, 3)
    np.testing.assert_allclose(geo.axis_op_windowed(40, 13, 3, w),
                               resample._axis_op_windowed(40, 13, 3, "zoom", w), atol=1e-6)
    assert np.array_equal(geo.axis_idx_windowed(13, 40, (20, 60, 3, 8)),
                          resample._axis_idx_windowed(13, 40, "zoom", (20, 60, 3, 8)))
    assert np.array_equal(geo.gaussian_importance_map((16, 16, 32)),
                          preprocess.gaussian_importance_map((16, 16, 32)))
    assert np.array_equal(geo.tile_starts((192, 192, 320), (128,) * 3, 0.5),
                          preprocess.tile_starts((192, 192, 320), (128,) * 3, 0.5))


def test_judge_of_the_five_part_merge():
    """Labels merged from each part's argmax (later parts over earlier ones)
    read a gap of zero; a label of the wrong part, or a part's label where a
    later part chose its own, reads the gap the reference gives it."""
    import json
    from pathlib import Path

    cfg = json.loads((Path(__file__).resolve().parents[2]
                      / "perfbench/configs/ts_total.json").read_text())
    gen = torch.Generator().manual_seed(5)
    shape = (6, 5, 4)
    logits = [torch.randn((m["num_classes"],) + shape, generator=gen) for m in cfg["models"]]
    for lg in logits:
        lg[0] += 1.0   # background often first, as with the background lead
    merged = ts_front.merged_labels(cfg, [lg.argmax(0) for lg in logits])

    class Geom:
        box = (0, shape[0], 0, shape[1])
        ornt = np.array([[0, 1.0], [1, 1.0], [2, 1.0]])
        index = [torch.arange(n) for n in shape]

    def judge(labels):
        j = ts_front.Judge(labels.numpy().astype(np.uint8), Geom, cfg, "cpu")
        for k, lg in enumerate(logits):
            j.add_model(k, lg)
        return j

    j = judge(merged)
    assert float(j.gap.max()) == 0.0 and j.outside_nonzero + j.bad_labels == 0
    wrong = merged.clone()
    wrong[0, 0, 0] = 200
    assert judge(wrong).bad_labels == 1
    # a label of part 0 where the merge shows another part's label
    k0 = cfg["models"][0]["part_to_task"]
    pos = (merged != 0).nonzero()[0]
    alt = merged.clone()
    alt[tuple(pos)] = k0[1] if int(merged[tuple(pos)]) != k0[1] else k0[2]
    assert float(judge(alt).gap[tuple(pos)]) > 0
