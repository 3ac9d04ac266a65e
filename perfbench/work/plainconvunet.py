"""Operations and compulsory bytes of nnU-Net's PlainConvUNet, layer by layer,
for one forward of one tile.

Counted from the network's shapes, whatever kernel runs a layer:
- a convolution: 2 * output voxels * kernel volume * c_in * c_out
  operations; the transposed conv (kernel = stride): 2 * output voxels *
  c_in * c_out; the 1x1x1 head likewise. Instance norm and the nonlinearity
  add no operations to the count (a few per element, under 1 % of a conv's);
- bytes: the layer's input read once, its output and its weights written
  and read once, at `act_bytes` an element (2: the bf16 the configuration
  computes in). A block's norm and nonlinearity are fused into its conv's
  read of the next layer, so they add no compulsory bytes.
"""

from __future__ import annotations

import numpy as np


def layers(net: dict, patch, num_classes: int, act_bytes: int = 2) -> list[dict]:
    """[{name, flops, bytes}] of one forward at the tile `patch`, named
    enc{s}.{b}, dec{i}.up, dec{i}.{b}, head (decoder i = 0 is the deepest)."""
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


def forward_flops(net: dict, patch, num_classes: int) -> float:
    """Operations of one tile forward."""
    return sum(layer["flops"] for layer in layers(net, patch, num_classes))
