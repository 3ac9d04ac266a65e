"""Experiment planner: fingerprint -> training plans, on the host.

Counterpart of `boa_tpu/engine/planner.py`, a copy (numpy only), so both
packages plan a dataset identically (nnU-Net's
`default_experiment_planner.py:24-574`): the target spacing (median, with
the 10th-percentile rule for strongly anisotropic axes), the initial patch
from the 1/spacing aspect ratio at 256^3 voxels clipped to the median
shape, the pooling topology, the shrink-under-budget loop on an analytic
count of activation elements (560e6 at batch 2, nnU-Net's 8 GB
reference), the 2d configuration, the 3d_lowres + cascade rule and the
ResEnc presets. The plan names (`boaTPUPlans*`) are the reference's, so
plans stay byte-equal across the packages.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

ANISO_THRESHOLD = 3.0
REFERENCE_VAL_3D = 560_000_000
REFERENCE_CORRESP_GB = 8.0
REFERENCE_CORRESP_BS = 2
FEATUREMAP_MIN_EDGE = 4
MAX_POOLS = 999
BASE_FEATURES = 32
MAX_FEATURES_3D = 320


def determine_target_spacing(spacings: np.ndarray, sizes: np.ndarray,
                             aniso_threshold: float = ANISO_THRESHOLD
                             ) -> np.ndarray:
    spacings = np.vstack(spacings)
    sizes = np.vstack(sizes)
    target = np.percentile(spacings, 50, 0)
    target_size = np.percentile(sizes, 50, 0)
    worst = int(np.argmax(target))
    other_axes = [i for i in range(len(target)) if i != worst]
    other_spacings = [target[i] for i in other_axes]
    other_sizes = [target_size[i] for i in other_axes]
    has_aniso_spacing = target[worst] > aniso_threshold * max(other_spacings)
    has_aniso_voxels = target_size[worst] * aniso_threshold < min(other_sizes)
    if has_aniso_spacing and has_aniso_voxels:
        t = np.percentile(spacings[:, worst], 10)
        if t < max(other_spacings):
            t = max(max(other_spacings), t) + 1e-5
        target[worst] = t
    return target


def pool_and_conv_props(spacing, patch_size,
                        min_edge: int = FEATUREMAP_MIN_EDGE):
    """(num_pool_per_axis, pool_kernels, conv_kernels, adjusted_patch).

    Axes with much coarser spacing start with kernel 1 and pool later
    (nnU-Net dynamic topology rules).
    """
    spacing = np.asarray(spacing, np.float64)
    patch = np.asarray(patch_size, np.int64).copy()
    dim = len(patch)
    num_pool_per_axis = np.zeros(dim, np.int64)
    pool_kernels: list[list[int]] = []
    conv_kernels: list[list[int]] = []
    cur_spacing = spacing.copy()
    cur_size = patch.astype(np.float64)
    # conv kernels start 1 per axis and are promoted (stickily) to 3 once
    # the axis's spacing is within 2x of the finest
    # (network_topology.py:75-83)
    kernel = [1] * dim
    while True:
        # axes eligible to pool: edge after pooling >= min_edge, then
        # spacing within 2x of the finest VALID axis
        # (network_topology.py:53-62 — the min is over size-valid axes, so
        # a size-exhausted fine axis cannot veto the others)
        valid = [i for i in range(dim) if cur_size[i] >= 2 * min_edge]
        if not valid:
            break
        min_sp_valid = min(cur_spacing[i] for i in valid)
        valid = [i for i in valid if cur_spacing[i] / min_sp_valid < 2]
        if not valid:
            break
        if len(valid) == 1 and cur_size[valid[0]] < 3 * min_edge:
            break  # lone-axis rule (network_topology.py:67-71)
        min_sp = float(np.min(cur_spacing))
        for d in range(dim):
            if kernel[d] == 1 and cur_spacing[d] / min_sp < 2:
                kernel[d] = 3
        pool = [1] * dim
        for v in valid:
            pool[v] = 2
            num_pool_per_axis[v] += 1
            cur_spacing[v] *= 2
            cur_size[v] = np.ceil(cur_size[v] / 2)
        pool_kernels.append(pool)
        conv_kernels.append(list(kernel))
    conv_kernels.append([3] * dim)  # bottleneck always 3^dim
    # patch pads UP to pooling divisibility (pad_shape semantics)
    must_div = 2 ** num_pool_per_axis
    patch = (np.ceil(patch / must_div) * must_div).astype(np.int64)
    n_stages = len(pool_kernels) + 1
    strides = [[1] * dim] + pool_kernels
    kernels = conv_kernels[:n_stages]
    return num_pool_per_axis.tolist(), strides, kernels, patch.tolist()


def estimate_activation_elements(patch_size, features_per_stage, strides,
                                 num_classes: int,
                                 n_conv_per_stage: int = 2) -> float:
    """Feature-map element count of one fwd pass (encoder+decoder+heads)."""
    size = np.asarray(patch_size, np.float64)
    total = 0.0
    sizes = []
    for s, (f, st) in enumerate(zip(features_per_stage, strides)):
        size = np.ceil(size / np.asarray(st))
        sizes.append(size.copy())
        total += n_conv_per_stage * f * float(np.prod(size))
    for s in range(len(features_per_stage) - 2, -1, -1):
        total += n_conv_per_stage * features_per_stage[s] * \
            float(np.prod(sizes[s]))
    total += num_classes * float(np.prod(patch_size))
    return total


def plan_configuration(fingerprint: dict, num_classes: int,
                       num_input_channels: int = 1,
                       hbm_target_gb: float = REFERENCE_CORRESP_GB,
                       overwrite_target_spacing=None) -> dict:
    spacings = np.vstack(fingerprint["spacings"])
    shapes = np.vstack(fingerprint["shapes_after_crop"])
    target = np.asarray(overwrite_target_spacing, np.float64) \
        if overwrite_target_spacing is not None else \
        determine_target_spacing(spacings, shapes)
    # median shape AFTER resampling to target spacing
    new_shapes = np.round(shapes * spacings / target[None]).astype(np.int64)
    median_shape = np.median(new_shapes, 0)

    tmp = 1.0 / target
    initial_patch = np.round(tmp * (256 ** 3 / np.prod(tmp)) ** (1 / 3))
    initial_patch = np.minimum(initial_patch, median_shape).astype(np.int64)
    initial_patch = np.maximum(initial_patch, FEATUREMAP_MIN_EDGE)

    def _feats(n_stages):
        return [min(MAX_FEATURES_3D, BASE_FEATURES * 2 ** i)
                for i in range(n_stages)]

    reference = REFERENCE_VAL_3D * (hbm_target_gb / REFERENCE_CORRESP_GB)
    patch = initial_patch.copy()
    while True:
        npool, strides, kernels, patch_adj = pool_and_conv_props(target, patch)
        feats = _feats(len(strides))
        est = estimate_activation_elements(patch_adj, feats, strides,
                                           num_classes)
        if est / REFERENCE_CORRESP_BS * 2 <= reference:
            break
        # shrink the largest-relative axis that can still shrink; the loop
        # re-plans and re-estimates (a break on the clamped axis would
        # return a stale over-budget estimate without trying other axes)
        ratios = [p / m for p, m in zip(patch_adj, median_shape)]
        patch = np.asarray(patch_adj, np.int64)
        for axis in np.argsort(ratios)[::-1]:
            axis = int(axis)
            must_div = 2 ** npool[axis]
            if patch[axis] - must_div >= FEATUREMAP_MIN_EDGE:
                patch[axis] -= must_div
                break
        else:
            break  # every axis at the topology minimum: best effort

    batch_size = max(REFERENCE_CORRESP_BS,
                     int(np.floor(reference / est * REFERENCE_CORRESP_BS)))
    # 5%-of-dataset cap (planner bs cap)
    total_vox = float(np.sum([np.prod(s) for s in new_shapes]))
    bs_cap = max(2, int(round(total_vox * 0.05 / np.prod(patch_adj))))
    batch_size = min(batch_size, bs_cap)

    n_stages = len(strides)
    ip = fingerprint["foreground_intensity_properties_per_channel"]
    return {
        "configurations": {
            "3d_fullres": {
                "data_identifier": "boaTPUPlans_3d_fullres",
                "patch_size": [int(p) for p in patch_adj],
                "spacing": [float(s) for s in target],
                "batch_size": int(batch_size),
                "batch_dice": True,
                "normalization_schemes": ["CTNormalization"],
                "use_mask_for_norm": [False],
                "resampling_fn_data": "resample_data_or_seg_to_shape",
                "resampling_fn_data_kwargs": {
                    "is_seg": False, "order": 3, "order_z": 0,
                    "force_separate_z": None},
                "resampling_fn_probabilities":
                    "resample_data_or_seg_to_shape",
                "resampling_fn_probabilities_kwargs": {
                    "is_seg": False, "order": 1, "order_z": 0,
                    "force_separate_z": None},
                "resampling_fn_seg": "resample_data_or_seg_to_shape",
                "resampling_fn_seg_kwargs": {
                    "is_seg": True, "order": 1, "order_z": 0,
                    "force_separate_z": None},
                "architecture": {
                    "network_class_name": "dynamic_network_architectures."
                                          "architectures.unet.PlainConvUNet",
                    "arch_kwargs": {
                        "n_stages": n_stages,
                        "features_per_stage": _feats(n_stages),
                        "kernel_sizes": kernels,
                        "strides": strides,
                        "n_conv_per_stage": [2] * n_stages,
                        "n_conv_per_stage_decoder": [2] * (n_stages - 1),
                        "conv_bias": True,
                        "norm_op_kwargs": {"eps": 1e-5, "affine": True},
                    },
                },
            }
        },
        "foreground_intensity_properties_per_channel": ip,
        "transpose_forward": [0, 1, 2],
        "transpose_backward": [0, 1, 2],
        "plans_name": "boaTPUPlans",
    }


REFERENCE_VAL_2D = 85_000_000
REFERENCE_BS_2D = 12
MAX_FEATURES_2D = 512
LOWRES_CREATION_THRESHOLD = 8.0  # median-volume / patch voxels ratio

#: ResEnc planner presets (nnU-Net ResEncUNetPlanner M/L/XL): VRAM
#: budget, residual block counts, single-conv decoder
RESENC_PRESETS = {
    "resenc_m": {"gb": 9.0},
    "resenc_l": {"gb": 24.0},
    "resenc_xl": {"gb": 40.0},
}
RESENC_BLOCKS = (1, 3, 4, 6, 6, 6, 6, 6)


def plan_configuration_2d(fingerprint: dict, num_classes: int,
                          hbm_target_gb: float = REFERENCE_CORRESP_GB,
                          target_spacing=None) -> dict:
    """2d configuration (`default_experiment_planner.py` 2D branch):
    in-plane target spacing, initial patch = median resampled in-plane
    shape, 2D topology grown under the 2D budget (85e6 elements @ batch
    12), max features 512."""
    spacings = np.vstack(fingerprint["spacings"])
    shapes = np.vstack(fingerprint["shapes_after_crop"])
    full_target = np.asarray(target_spacing, np.float64) \
        if target_spacing is not None else \
        determine_target_spacing(spacings, shapes)
    # 2d keeps the native through-plane spacing; plan in-plane only.
    # This repo's volumes are (x, y, z) with through-plane z LAST (nnU-Net
    # stores (z, y, x) and takes [1:]), so the in-plane axes are [:2].
    inplane = full_target[:2] if len(full_target) == 3 else full_target
    new_shapes = np.round(shapes[:, :2] * spacings[:, :2] / inplane[None]
                          ).astype(np.int64)
    median_shape = np.median(new_shapes, 0)
    patch = np.maximum(median_shape.astype(np.int64), FEATUREMAP_MIN_EDGE)

    def _feats(n_stages):
        return [min(MAX_FEATURES_2D, BASE_FEATURES * 2 ** i)
                for i in range(n_stages)]

    reference = REFERENCE_VAL_2D * (hbm_target_gb / REFERENCE_CORRESP_GB)
    while True:
        npool, strides, kernels, patch_adj = pool_and_conv_props(
            inplane, patch)
        feats = _feats(len(strides))
        est = estimate_activation_elements(patch_adj, feats, strides,
                                           num_classes)
        if est <= reference:
            break
        ratios = [p / m for p, m in zip(patch_adj, median_shape)]
        patch = np.asarray(patch_adj, np.int64)
        for axis in np.argsort(ratios)[::-1]:
            axis = int(axis)
            must_div = 2 ** npool[axis]
            if patch[axis] - must_div >= FEATUREMAP_MIN_EDGE:
                patch[axis] -= must_div
                break
        else:
            break  # every axis at the topology minimum: best effort

    batch_size = max(REFERENCE_BS_2D,
                     int(np.floor(reference / est * REFERENCE_BS_2D)))
    total_px = float(np.sum([np.prod(s) for s in new_shapes]))
    batch_size = min(batch_size,
                     max(2, int(round(total_px * 0.05 / np.prod(patch_adj)))))
    n_stages = len(strides)
    return {
        "data_identifier": "boaTPUPlans_2d",
        "patch_size": [int(p) for p in patch_adj],
        "spacing": [float(s) for s in inplane],
        "batch_size": int(batch_size),
        "batch_dice": True,
        "normalization_schemes": ["CTNormalization"],
        "use_mask_for_norm": [False],
        "architecture": {
            "network_class_name": "dynamic_network_architectures."
                                  "architectures.unet.PlainConvUNet",
            "arch_kwargs": {
                "n_stages": n_stages,
                "features_per_stage": _feats(n_stages),
                "kernel_sizes": kernels,
                "strides": strides,
                "n_conv_per_stage": [2] * n_stages,
                "n_conv_per_stage_decoder": [2] * (n_stages - 1),
                "conv_bias": True,
                "norm_op_kwargs": {"eps": 1e-5, "affine": True},
            },
        },
    }


def _median_resampled_shape(fingerprint: dict, spacing) -> np.ndarray:
    spacings = np.vstack(fingerprint["spacings"])
    shapes = np.vstack(fingerprint["shapes_after_crop"])
    new_shapes = np.round(shapes * spacings / np.asarray(spacing)[None])
    return np.median(new_shapes, 0)


def plan_lowres_and_cascade(plans: dict, fingerprint: dict,
                            num_classes: int,
                            hbm_target_gb: float = REFERENCE_CORRESP_GB
                            ) -> None:
    """Add 3d_lowres + 3d_cascade_fullres when the fullres patch covers
    too little context (median volume > 8x the patch voxels — the
    planner's lowres-creation rule). The lowres spacing is grown in 1%
    steps, replanning each time, until the ratio drops under threshold;
    the cascade fullres stage inherits 3d_fullres and consumes the lowres
    segmentation as its previous stage."""
    full = plans["configurations"]["3d_fullres"]
    patch_vox = float(np.prod(full["patch_size"]))
    median = _median_resampled_shape(fingerprint, full["spacing"])
    if float(np.prod(median)) / patch_vox <= LOWRES_CREATION_THRESHOLD:
        return
    spacing = np.asarray(full["spacing"], np.float64)
    lowres_conf = None
    for _ in range(200):
        spacing = spacing * 1.01
        cand = plan_configuration(fingerprint, num_classes,
                                  hbm_target_gb=hbm_target_gb,
                                  overwrite_target_spacing=spacing)
        conf = cand["configurations"]["3d_fullres"]
        median = _median_resampled_shape(fingerprint, conf["spacing"])
        ratio = float(np.prod(median)) / float(np.prod(conf["patch_size"]))
        lowres_conf = conf
        if ratio <= LOWRES_CREATION_THRESHOLD:
            break
    lowres_conf = dict(lowres_conf)
    lowres_conf["data_identifier"] = "boaTPUPlans_3d_lowres"
    lowres_conf["next_stage"] = "3d_cascade_fullres"
    plans["configurations"]["3d_lowres"] = lowres_conf
    plans["configurations"]["3d_cascade_fullres"] = {
        "inherits_from": "3d_fullres",
        "previous_stage": "3d_lowres",
    }


def _apply_resenc(conf: dict) -> None:
    arch = conf["architecture"]
    kwargs = arch["arch_kwargs"]
    n = kwargs["n_stages"]
    arch["network_class_name"] = ("dynamic_network_architectures."
                                  "architectures.residual_unet."
                                  "ResidualEncoderUNet")
    kwargs["n_blocks_per_stage"] = list(RESENC_BLOCKS[:n])
    kwargs["n_conv_per_stage_decoder"] = [1] * (n - 1)
    kwargs.pop("n_conv_per_stage", None)


def plan_experiment(fingerprint: dict, num_classes: int,
                    out_file: str | Path | None = None,
                    hbm_target_gb: float = REFERENCE_CORRESP_GB,
                    configurations=("2d", "3d_fullres", "3d_lowres"),
                    preset: str | None = None) -> dict:
    """Full plan generation: 3d_fullres (+2d, +3d_lowres/cascade when
    requested/warranted), optionally under a ResEnc preset
    (`resenc_m`/`resenc_l`/`resenc_xl` — ResEncUNetPlanner budgets with
    residual encoders and single-conv decoder stages)."""
    if preset is not None:
        hbm_target_gb = RESENC_PRESETS[preset]["gb"]
    plans = plan_configuration(fingerprint, num_classes,
                               hbm_target_gb=hbm_target_gb)
    if "2d" in configurations:
        plans["configurations"]["2d"] = plan_configuration_2d(
            fingerprint, num_classes, hbm_target_gb=hbm_target_gb)
    if "3d_lowres" in configurations:
        plan_lowres_and_cascade(plans, fingerprint, num_classes,
                                hbm_target_gb=hbm_target_gb)
    if preset is not None:
        plans["plans_name"] = f"boaTPUPlans_{preset}"
        for name, conf in plans["configurations"].items():
            if "architecture" in conf:
                _apply_resenc(conf)
    if out_file:
        Path(out_file).write_text(json.dumps(plans, indent=2))
    return plans
