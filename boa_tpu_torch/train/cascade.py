"""Cascade staging: low-resolution predictions -> the next stage's inputs.

Counterpart of `boa_tpu/train/cascade.py` (nnU-Net's
`nnUNetTrainer.py:1251-1337`, predicted_next_stage): every case of the
low-resolution `CaseStore` is predicted with the sliding window on the
port's network, the labels are nearest-resampled to the target store's
grid and attached with `CaseStore.save_prev_seg`, where the cascade
`DataLoader` reads them.
"""

from __future__ import annotations

import logging
from typing import Sequence

import numpy as np
import torch

from boa_tpu_torch.device import resolve_device
from boa_tpu_torch.models.unet import ArchConfig
from boa_tpu_torch.train.dataset import CaseStore

logger = logging.getLogger(__name__)


@torch.no_grad()
def predict_next_stage(params, arch: ArchConfig, lowres_store: CaseStore,
                       target_store: CaseStore, patch: Sequence[int],
                       case_ids: Sequence[str] | None = None,
                       step_size: float = 0.5, device=None) -> list[str]:
    """Attach the low-resolution model's labels to `target_store`. `params`
    is one fold's numpy pytree of `arch`; the cases are the preprocessed
    low-resolution arrays, so the network runs on them directly. On the
    card by default (bf16, the K1-K3 composite where it applies). Returns
    the case ids done."""
    from boa_tpu_torch.inference.sliding_window import sliding_window_logits
    from boa_tpu_torch.models.unet import cast_model
    from boa_tpu_torch.ops import preprocess as pp
    from boa_tpu_torch.ops import resample as rs
    from boa_tpu_torch.weights.convert import params_from_numpy

    dev = resolve_device(device)
    patch = tuple(patch)
    model = cast_model(params_from_numpy(params, arch, device=dev), torch.bfloat16)
    gauss = pp.gaussian_importance_map(patch)
    ids = list(case_ids) if case_ids is not None else lowres_store.case_ids()
    done = []
    for cid in ids:
        case = lowres_store.load_case(cid, memmap=False)
        data = np.asarray(case.data, np.float32)
        padded, revert = pp.pad_to_patch(data, patch)
        starts = pp.tile_starts(padded.shape[-3:], patch, step_size)
        logits = sliding_window_logits([model], torch.from_numpy(padded).to(dev), starts,
                                       gauss, arch.num_classes,
                                       accum_dtype=torch.float32)
        seg = torch.argmax(logits, dim=0)[revert]
        target_shape = np.load(target_store.root / f"{cid}_seg.npy", mmap_mode="r").shape
        if tuple(seg.shape) != tuple(target_shape):
            seg = rs.resample_nearest(seg, tuple(target_shape), convention="resize")
        target_store.save_prev_seg(cid, seg.cpu().numpy())
        done.append(cid)
        logger.info("next-stage seg for %s: %s -> %s", cid, tuple(data.shape[-3:]),
                    tuple(target_shape))
    return done
