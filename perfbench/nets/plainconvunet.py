"""nnU-Net's PlainConvUNet (dynamic_network_architectures, nnU-Net v2), the
network family `PlainConvUNet` of a configuration's `network`.

Per encoder stage `n_conv` blocks of Conv3d (the first at the stage's
stride) -> InstanceNorm3d(affine, eps) -> LeakyReLU(slope); per decoder
stage a ConvTranspose3d(kernel = stride) upsampling, the concatenation
[upsampled, skip] and `n_conv` blocks; a 1x1x1 head on the last decoder
stage.

- `leaf_specs`: the parameter tree and its init bounds (kaiming-uniform
  a=sqrt(5) for conv weights, 1/sqrt(fan_in) for biases, ones and zeros for
  the norms), a frozen copy of `boa_tpu_torch/weights/store.py:init_params_numpy`;
- `arch`: the `plans.json` architecture block of
  `boa_tpu_torch/plans/plans.py:synthetic_plans`;
- `forward`: the plain float32 reference (`reference/unet.py`'s pieces:
  `torch.nn.functional` calls on the leaves as the benchmark made them, no
  kernel of the port, no packing and no caching);
- `layers`: operations and compulsory bytes, layer by layer, of one tile
  forward.

Leaves use the store's layout: a conv weight is (kx, ky, kz, c_in, c_out),
the transposed conv's (kx, ky, kz, c_out, c_in).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.reference import unet


def leaf_specs(net: dict, num_classes: int) -> list[tuple[tuple, tuple, float]]:
    """(path, shape, bound) of every leaf, in the init's order, the last
    head's bias last; bound > 0 draws U(-bound, bound), 0 gives zeros, -1
    ones."""
    specs: list = []
    n_st = len(net["features_per_stage"])
    feats, ks, strides = net["features_per_stage"], net["kernel_sizes"], net["strides"]

    def conv(path, kernel, cin, cout, bias=True):
        fan_in = cin * int(np.prod(kernel))
        specs.append((path + ("w",), tuple(kernel) + (cin, cout),
                      math.sqrt(2.0 / 6.0) * math.sqrt(3.0 / fan_in)))
        if bias:
            specs.append((path + ("b",), (cout,), 1.0 / math.sqrt(fan_in)))

    def block(path, kernel, cin, cout):
        conv(path, kernel, cin, cout, bool(net["conv_bias"]))
        specs.append((path + ("norm_scale",), (cout,), -1.0))
        specs.append((path + ("norm_bias",), (cout,), 0.0))

    c_in = int(net["input_channels"])
    for s in range(n_st):
        for b in range(net["n_conv_per_stage"][s]):
            block(("encoder", s, b), ks[s], c_in, feats[s])
            c_in = feats[s]
    for i, s in enumerate(range(n_st - 1, 0, -1)):
        c_below, c_skip = feats[s], feats[s - 1]
        conv(("decoder", i, "transp"), strides[s], c_skip, c_below, bias=False)
        specs.append((("decoder", i, "transp", "b"), (c_skip,),
                      1.0 / math.sqrt(c_below * int(np.prod(strides[s])))))
        c = 2 * c_skip
        for b in range(net["n_conv_per_stage_decoder"][n_st - 1 - s]):
            block(("decoder", i, "convs", b), ks[s - 1], c, c_skip)
            c = c_skip
        conv(("seg_heads", i), (1, 1, 1), c_skip, num_classes)
    return specs


def arch(net: dict) -> dict:
    """The `plans.json` architecture block."""
    return {
        "network_class_name":
            "dynamic_network_architectures.architectures.unet.PlainConvUNet",
        "arch_kwargs": {
            "n_stages": len(net["features_per_stage"]),
            "features_per_stage": list(net["features_per_stage"]),
            "kernel_sizes": [list(k) for k in net["kernel_sizes"]],
            "strides": [list(s) for s in net["strides"]],
            "n_conv_per_stage": list(net["n_conv_per_stage"]),
            "n_conv_per_stage_decoder": list(net["n_conv_per_stage_decoder"]),
            "conv_bias": bool(net["conv_bias"]),
            "norm_op_kwargs": {"eps": float(net["norm_eps"]), "affine": True},
            "nonlin_kwargs": {"negative_slope": float(net["nonlin_slope"]),
                              "inplace": True},
        },
    }


@torch.no_grad()
def forward(params: dict, net: dict, x: torch.Tensor, fp8: bool = False) -> torch.Tensor:
    """(N, C, X, Y, Z) float32 -> logits (N, classes, X, Y, Z) float32, to be
    run under `unet.exact_float32()`; `fp8=True` is the control
    (`unet.round_e4m3` on both operands of every convolution).

    `net` holds the configuration's network keys (`strides`, `norm_eps`,
    `nonlin_slope`); `params` the leaves as float32 tensors on x's device."""
    eps, slope = float(net["norm_eps"]), float(net["nonlin_slope"])
    strides = net["strides"]
    skips = []
    h = x.float()
    for s, stage in enumerate(params["encoder"]):
        for b, blk in enumerate(stage):
            h = unet.conv_block(h, blk, strides[s] if b == 0 else (1, 1, 1), eps, slope, fp8)
        skips.append(h)
    y = skips[-1]
    n = len(skips)
    for i, st in enumerate(params["decoder"]):
        w = unet.transp_weight(st["transp"]["w"])
        up_in = y
        if fp8:
            up_in, w = unet.round_e4m3(up_in), unet.round_e4m3(w)
        stride = tuple(strides[n - 1 - i])
        y = F.conv_transpose3d(up_in, w, st["transp"]["b"], stride=stride)
        y = torch.cat([y, skips[n - 2 - i]], dim=1)
        for blk in st["convs"]:
            y = unet.conv_block(y, blk, (1, 1, 1), eps, slope, fp8)
    head = params["seg_heads"][-1]
    w = unet.conv_weight(head["w"])
    if fp8:
        y, w = unet.round_e4m3(y), unet.round_e4m3(w)
    return F.conv3d(y, w, head["b"])


def layers(net: dict, patch, num_classes: int, act_bytes: int = 2) -> list[dict]:
    """[{name, flops, bytes}] of one forward at the tile `patch`, named
    enc{s}.{b}, dec{i}.up, dec{i}.{b}, head (decoder i = 0 is the deepest).

    Counted from the network's shapes, whatever kernel runs a layer:
    - a convolution: 2 * output voxels * kernel volume * c_in * c_out
      operations; the transposed conv (kernel = stride): 2 * output voxels *
      c_in * c_out; the 1x1x1 head likewise. Instance norm and the
      nonlinearity add no operations to the count (a few per element, under
      1 % of a conv's);
    - bytes: the layer's input read once, its output and its weights written
      and read once, at `act_bytes` an element (2: the bf16 the configuration
      computes in). A block's norm and nonlinearity are fused into its conv's
      read of the next layer, so they add no compulsory bytes.
    """
    out = []
    n = len(net["features_per_stage"])
    feats, ks, strides = net["features_per_stage"], net["kernel_sizes"], net["strides"]

    def add(name, vin, vout, cin, cout, taps, flops=None):
        out.append({"name": name,
                    "flops": 2.0 * vout * taps * cin * cout if flops is None else flops,
                    "bytes": float(act_bytes) * (vin * cin + vout * cout + taps * cin * cout)})

    shape = np.array(patch, dtype=np.int64)
    shapes = []
    c_in = int(net["input_channels"])
    for s in range(n):
        for b in range(net["n_conv_per_stage"][s]):
            st = np.array(strides[s] if b == 0 else (1, 1, 1))
            new = shape // st
            add(f"enc{s}.{b}", int(shape.prod()), int(new.prod()), c_in, feats[s],
                int(np.prod(ks[s])))
            shape, c_in = new, feats[s]
        shapes.append(shape)
    for i, s in enumerate(range(n - 1, 0, -1)):
        up = shapes[s - 1]
        add(f"dec{i}.up", int(shapes[s].prod()), int(up.prod()), feats[s], feats[s - 1],
            int(np.prod(strides[s])), flops=2.0 * int(up.prod()) * feats[s] * feats[s - 1])
        c = 2 * feats[s - 1]
        for b in range(net["n_conv_per_stage_decoder"][n - 1 - s]):
            add(f"dec{i}.{b}", int(up.prod()), int(up.prod()), c, feats[s - 1],
                int(np.prod(ks[s - 1])))
            c = feats[s - 1]
    v = int(shapes[0].prod())
    add("head", v, v, feats[0], num_classes, 1)
    return out
