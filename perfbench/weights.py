"""Seeded weights of a configuration, made on the device, and the store that
the port reads them from.

Frozen copies, each from the file it names:
- the parameter tree and its init bounds (kaiming-uniform a=sqrt(5) for
  conv weights, 1/sqrt(fan_in) for biases, ones and zeros for the norms):
  `boa_tpu_torch/weights/store.py:init_params_numpy` (PlainConvUNet only);
  the values are drawn here with one `torch.Generator` on the device, in one
  call, and differ from that function's numpy draws;
- the head-bias rule (the last head's bias plus N(0, sd) drawn from a fixed
  seed, `seed + task id`, whatever the run's seed, so that random weights
  label organ-sized regions ranked alike in every run) and the background
  lead (background's bias above the largest other by `lead`, so that a
  sub-model of `total` leaves room to the ones merged before it):
  `chip_smoke.py:_synthetic`;
- the store layout (`Dataset{id:03d}_{name}/{trainer}__nnUNetPlans__3d_fullres/`
  with `plans.json`, `dataset.json`, `fold_0/checkpoint_final.npz` holding
  '/'-joined leaf paths): `boa_tpu_torch/weights/store.py:_write_store_entry`
  and `boa_tpu_torch/weights/convert.py:_flatten`, written uncompressed;
- the plans and dataset dictionaries: `boa_tpu_torch/plans/plans.py:synthetic_plans`,
  with the configuration file's values.
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np
import torch


def leaf_specs(net: dict, num_classes: int) -> list[tuple[tuple, tuple, float]]:
    """(path, shape, bound) of every leaf, in the init's order; bound > 0
    draws U(-bound, bound), 0 gives zeros, -1 ones."""
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


def _tree_set(tree: dict, path: tuple, value) -> None:
    node = tree
    for key, nxt in zip(path[:-1], path[1:]):
        if isinstance(node, list):
            if len(node) == key:
                node.append([] if isinstance(nxt, int) else {})
            node = node[key]
        else:
            node = node.setdefault(key, [] if isinstance(nxt, int) else {})
    if isinstance(node, list):
        node.append(value)
    else:
        node[path[-1]] = value


def make_params(net: dict, num_classes: int, gen: torch.Generator, device,
                head_bias: dict, task_id: int) -> dict:
    """The parameter tree as float32 tensors on `device`: every uniform leaf
    from one draw of `gen`, then the head-bias rule of `head_bias` (`sd`,
    `seed`, `background_lead`)."""
    specs = leaf_specs(net, num_classes)
    total = sum(int(np.prod(shape)) for _, shape, _ in specs)
    flat = torch.rand(total, generator=gen, device=device, dtype=torch.float32)
    tree: dict = {}
    off = 0
    for path, shape, bound in specs:
        n = int(np.prod(shape))
        if bound > 0:
            leaf = (flat[off:off + n] * (2 * bound) - bound).view(shape)
        else:
            leaf = torch.full(shape, 1.0 if bound < 0 else 0.0, device=device)
        off += n
        _tree_set(tree, path, leaf)
    head = tree["seg_heads"][-1]
    bias_gen = torch.Generator(device=device)
    bias_gen.manual_seed(int(head_bias["seed"]) + task_id)
    head["b"] = head["b"] + float(head_bias["sd"]) * torch.randn(
        head["b"].shape, generator=bias_gen, device=device)
    if head_bias.get("background_lead") is not None:
        head["b"][0] = head["b"][1:].max() + float(head_bias["background_lead"])
    return tree


def flatten(node, prefix: str = "", out: dict | None = None) -> dict:
    """'/'-joined leaf paths -> host float32 arrays (dict keys sorted)."""
    out = {} if out is None else out
    if isinstance(node, dict):
        for k in sorted(node):
            flatten(node[k], f"{prefix}{k}/", out)
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            flatten(v, f"{prefix}{i}/", out)
    else:
        out[prefix[:-1]] = node.detach().float().cpu().numpy()
    return out


def plans_dicts(cfg: dict, num_classes: int) -> tuple[dict, dict]:
    """(plans.json, dataset.json) of one model of the configuration."""
    net = cfg["network"]
    n = len(net["features_per_stage"])
    conf = {
        "architecture": {
            "network_class_name":
                "dynamic_network_architectures.architectures.unet.PlainConvUNet",
            "arch_kwargs": {
                "n_stages": n,
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
        },
        "patch_size": list(cfg["patch_size"]),
        "spacing": list(cfg["spacing"]),
        "normalization_schemes": ["CTNormalization"],
        "use_mask_for_norm": [False],
        "resampling_fn_data": "resample_data_or_seg_to_shape",
        "resampling_fn_data_kwargs": {
            "is_seg": False, "order": 3, "order_z": 0, "force_separate_z": None},
        "resampling_fn_probabilities": "resample_data_or_seg_to_shape",
        "resampling_fn_probabilities_kwargs": {
            "is_seg": False, "order": 1, "order_z": 0, "force_separate_z": None},
        "batch_size": 2,
        "batch_dice": True,
    }
    ip = cfg["intensity"]
    plans = {
        "plans_name": "nnUNetPlans",
        "transpose_forward": [0, 1, 2],
        "transpose_backward": [0, 1, 2],
        "configurations": {"3d_fullres": conf},
        "foreground_intensity_properties_per_channel": {"0": {
            "mean": ip["mean"], "std": ip["std"],
            "percentile_00_5": ip["percentile_00_5"],
            "percentile_99_5": ip["percentile_99_5"],
            "min": ip["percentile_00_5"] - 100, "max": ip["percentile_99_5"] + 100,
            "median": ip["mean"]}},
    }
    labels = {"background": 0}
    labels.update({f"class_{i}": i for i in range(1, num_classes)})
    dataset = {"labels": labels, "channel_names": {"0": "CT"}, "file_ending": ".nii.gz"}
    return plans, dataset


def write_store(root: Path, model: dict, cfg: dict, params: dict) -> Path:
    """One model's folder in the store layout; returns the model directory."""
    mdir = (Path(root) / f"Dataset{int(model['task_id']):03d}_{model['dataset']}"
            / f"{model['trainer']}__nnUNetPlans__3d_fullres")
    (mdir / "fold_0").mkdir(parents=True, exist_ok=True)
    plans, dataset = plans_dicts(cfg, int(model["num_classes"]))
    (mdir / "plans.json").write_text(json.dumps(plans))
    (mdir / "dataset.json").write_text(json.dumps(dataset))
    np.savez(mdir / "fold_0" / "checkpoint_final.npz", **flatten(params))
    return mdir
