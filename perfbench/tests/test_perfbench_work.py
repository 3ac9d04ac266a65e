"""Work counts against a hand count, and the roofline reader on a made-up trace."""

import pytest

from perfbench.nets import plainconvunet
from perfbench.work import bounds, h100, roofline, rowconv

NET = {"features_per_stage": [4, 8], "kernel_sizes": [[3, 3, 3]] * 2,
       "strides": [[1, 1, 1], [2, 2, 2]], "n_conv_per_stage": [2, 2],
       "n_conv_per_stage_decoder": [2], "input_channels": 1}


def test_small_unet_by_hand():
    got = {x["name"]: x for x in plainconvunet.layers(NET, (8, 8, 8), 3)}
    v, v2 = 512, 64
    by_hand = {
        "enc0.0": (2 * v * 27 * 1 * 4, 2 * (v * 1 + v * 4 + 27 * 1 * 4)),
        "enc0.1": (2 * v * 27 * 4 * 4, 2 * (v * 4 + v * 4 + 27 * 4 * 4)),
        "enc1.0": (2 * v2 * 27 * 4 * 8, 2 * (v * 4 + v2 * 8 + 27 * 4 * 8)),
        "enc1.1": (2 * v2 * 27 * 8 * 8, 2 * (v2 * 8 + v2 * 8 + 27 * 8 * 8)),
        "dec0.up": (2 * v * 8 * 4, 2 * (v2 * 8 + v * 4 + 8 * 8 * 4)),
        "dec0.0": (2 * v * 27 * 8 * 4, 2 * (v * 8 + v * 4 + 27 * 8 * 4)),
        "dec0.1": (2 * v * 27 * 4 * 4, 2 * (v * 4 + v * 4 + 27 * 4 * 4)),
        "head": (2 * v * 4 * 3, 2 * (v * 4 + v * 3 + 4 * 3)),
    }
    assert list(got) == list(by_hand)
    for name, (flops, nbytes) in by_hand.items():
        assert got[name]["flops"] == flops and got[name]["bytes"] == nbytes, name
    assert sum(x["flops"] for x in got.values()) == sum(f for f, _ in by_hand.values())


def test_published_net_k1_bound():
    net = {"features_per_stage": [32, 64, 128, 256, 320, 320],
           "kernel_sizes": [[3, 3, 3]] * 6, "strides": [[1, 1, 1]] + [[2, 2, 2]] * 5,
           "n_conv_per_stage": [2] * 6, "n_conv_per_stage_decoder": [2] * 5,
           "input_channels": 1}
    layers = {x["name"]: x for x in plainconvunet.layers(net, (128,) * 3, 118)}
    k1 = sum(bounds.least_seconds(layers[n]["flops"], layers[n]["bytes"])
             for n in rowconv.layer_names("k1", 6))
    assert k1 == pytest.approx(0.510e-3, rel=0.01)   # PERF.md's K1 bound a tile
    assert sum(x["flops"] for x in layers.values()) == pytest.approx(0.970e12, rel=1e-3)


def test_roofline_share_from_a_trace():
    cfg = {"network": dict(NET, n_stages=2), "patch_size": [8, 8, 8],
           "models": [{"task_id": 1, "num_classes": 3}]}
    layers = {x["name"]: x for x in plainconvunet.layers(NET, (8, 8, 8), 3)}
    least = sum(bounds.least_seconds(layers[n]["flops"], layers[n]["bytes"])
                for n in rowconv.layer_names("k1", 2))
    art = {"config": cfg, "family": plainconvunet,
           "launches": {"conv3d_rows": 8, "conv3d_in_act": 0},
           "trace": {"kernel_s": {"void conv_in_act_kernel<64>(...)": 3 * least,
                                  "conv1_kernel": least, "elementwise": 5.0}}}
    assert roofline.share(art, ("k1",)) == pytest.approx(50.0)
    art["launches"]["conv3d_in_act"] = 1
    assert roofline.share(art, ("k1",)) is None
    assert h100.BF16_FLOP_PER_S == 989e12
