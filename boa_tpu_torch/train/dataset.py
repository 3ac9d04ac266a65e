"""Preprocessed-case storage and the class-location sampling index.

Counterpart of `boa_tpu/train/dataset.py`, a copy on the same on-disk
layout, so either package trains on the other's store: per case
``{id}_data.npy`` (C, X, Y, Z) float32, ``{id}_seg.npy`` int8/int16,
``{id}_locs.npz`` (up to 10k voxel coordinates per class, at least 1 % of
a large class, nnU-Net's `_sample_foreground_locations`),
``{id}_props.json`` and, for a cascade stage, ``{id}_prevseg.npy``.
Cases are opened with np.memmap, so a patch crop is a strided read.
`generate_splits` is sklearn's ``KFold(5, shuffle=True,
random_state=12345)`` over the sorted ids, without sklearn, as
`nnUNetTrainer.do_split` writes splits_final.json.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

import numpy as np

MAX_LOCS_PER_CLASS = 10_000  # nnU-Net num_foreground_voxels_for_oversampling


def sample_class_locations(seg: np.ndarray, labels: list[int],
                           seed: int = 1234,
                           max_per_class: int = MAX_LOCS_PER_CLASS
                           ) -> dict[int, np.ndarray]:
    """{label: (N, 3) voxel coords} capped at max_per_class (reference
    `DefaultPreprocessor._sample_foreground_locations`)."""
    rng = np.random.RandomState(seed)
    out: dict[int, np.ndarray] = {}
    for lb in labels:
        coords = np.argwhere(seg == lb)
        # min_percent_coverage rule: at least 1% of a big class's voxels
        # (reference target = max(min(10000, n), ceil(n * 0.01)))
        target = max(min(max_per_class, len(coords)),
                     int(np.ceil(len(coords) * 0.01)))
        if len(coords) > target:
            idx = rng.choice(len(coords), target, replace=False)
            coords = coords[idx]
        out[int(lb)] = coords.astype(np.int32)
    return out


@dataclass
class Case:
    data: np.ndarray           # (C, X, Y, Z) fp32 (possibly memmap)
    seg: np.ndarray            # (X, Y, Z) int8/int16 (possibly memmap)
    class_locations: dict[int, np.ndarray]
    properties: dict
    # cascade training: previous-stage prediction on this case's grid
    # (nnU-Net's predicted_next_stage files, nnunet_dataset.py seg_prev)
    prev_seg: np.ndarray | None = None


class CaseStore:
    """Directory of preprocessed training cases."""

    def __init__(self, root: str | Path):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)

    def case_ids(self) -> list[str]:
        return sorted(p.stem.removesuffix("_data")
                      for p in self.root.glob("*_data.npy"))

    def save_case(self, case_id: str, data: np.ndarray, seg: np.ndarray,
                  properties: dict | None = None,
                  labels: list[int] | None = None) -> None:
        data = np.asarray(data, np.float32)
        if data.ndim == 3:
            data = data[None]
        seg = np.asarray(seg)
        seg = seg.astype(np.int16 if seg.max(initial=0) > 127 else np.int8)
        np.save(self.root / f"{case_id}_data.npy", data)
        np.save(self.root / f"{case_id}_seg.npy", seg)
        if labels is None:
            labels = [int(lb) for lb in np.unique(seg) if lb > 0]
        locs = sample_class_locations(seg, labels)
        np.savez_compressed(self.root / f"{case_id}_locs.npz",
                            **{str(k): v for k, v in locs.items()})
        (self.root / f"{case_id}_props.json").write_text(
            json.dumps(properties or {}))

    def save_prev_seg(self, case_id: str, prev_seg: np.ndarray) -> None:
        """Attach a previous-stage segmentation (same grid as the case) —
        the cascade's predicted_next_stage artifact."""
        prev_seg = np.asarray(prev_seg)
        case_shape = np.load(self.root / f"{case_id}_seg.npy",
                             mmap_mode="r").shape
        if tuple(prev_seg.shape) != tuple(case_shape):
            raise ValueError(f"prev_seg shape {prev_seg.shape} != case seg "
                             f"shape {case_shape} for {case_id}")
        np.save(self.root / f"{case_id}_prevseg.npy",
                prev_seg.astype(np.int16 if prev_seg.max(initial=0) > 127
                                else np.int8))

    def has_prev_segs(self) -> bool:
        ids = self.case_ids()
        return bool(ids) and all(
            (self.root / f"{cid}_prevseg.npy").exists() for cid in ids)

    def load_case(self, case_id: str, memmap: bool = True) -> Case:
        mode = "r" if memmap else None
        data = np.load(self.root / f"{case_id}_data.npy", mmap_mode=mode)
        seg = np.load(self.root / f"{case_id}_seg.npy", mmap_mode=mode)
        locs_npz = np.load(self.root / f"{case_id}_locs.npz")
        locs = {int(k): locs_npz[k] for k in locs_npz.files}
        props = json.loads(
            (self.root / f"{case_id}_props.json").read_text())
        prev_p = self.root / f"{case_id}_prevseg.npy"
        prev = np.load(prev_p, mmap_mode=mode) if prev_p.exists() else None
        return Case(data=data, seg=seg, class_locations=locs,
                    properties=props, prev_seg=prev)


def generate_splits(case_ids, n_splits: int = 5, seed: int = 12345) -> list:
    """Deterministic K-fold split over sorted case ids.

    Parity: `nnUNetTrainer.do_split` — sklearn
    ``KFold(n_splits=5, shuffle=True, random_state=12345)`` over the
    sorted keys, written to splits_final.json. Reproduced here without
    sklearn: the legacy RandomState shuffle + consecutive test chunks is
    exactly what KFold does, so splits match nnU-Net's byte for byte.
    """
    keys = np.sort(np.asarray(list(case_ids)))
    n = len(keys)
    idx = np.arange(n)
    np.random.RandomState(seed).shuffle(idx)
    fold_sizes = np.full(n_splits, n // n_splits, np.int64)
    fold_sizes[: n % n_splits] += 1
    splits, cur = [], 0
    for fs in fold_sizes:
        # KFold yields indices through a boolean mask, i.e. ascending
        test = np.sort(idx[cur:cur + int(fs)])
        cur += int(fs)
        train = np.setdiff1d(idx, test)
        splits.append({"train": [str(k) for k in keys[train]],
                       "val": [str(k) for k in keys[test]]})
    return splits


def load_or_create_splits(store: CaseStore, n_splits: int = 5) -> list:
    """splits_final.json beside the cases: read it, or create + persist."""
    path = store.root / "splits_final.json"
    if path.exists():
        return json.loads(path.read_text())
    splits = generate_splits(store.case_ids(), n_splits)
    path.write_text(json.dumps(splits, indent=2))
    return splits
