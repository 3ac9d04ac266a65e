"""Training batch sampler with foreground oversampling and a prefetch thread.

Counterpart of `boa_tpu/train/dataloader.py` (nnU-Net's
`data_loader.py:91-165`), a copy: the same numpy `RandomState` draws, so a
seed gives the reference's batches bit for bit. A sample is
foreground-forced by its position in the batch
(`nnUNetTrainer._set_batch_size_and_oversample:346-390`, or a Bernoulli
draw for the probabilistic variant) and centred on a random class
location; crops pad symmetrically out of bounds (data 0, seg -1, then
background). A cascade batch carries the previous stage's labels with
random connected components dropped on the host.

On the card, one producer thread builds the batches and copies each into
pinned memory (`prefetched(pin=True)`); `to_device` sends it with
``non_blocking=True``, so the copy overlaps the step before it.
Augmentation runs on the device (`train/augment.py`).

On a device mesh each dp rank loads its part of the global batch
(`part=(i, k)`: rows i*B/k to (i+1)*B/k): the random draws are those of the
whole batch, so the parts put together are the one-process batch, but only
the rank's own rows are cropped and copied.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np

import torch

from boa_tpu_torch.train.dataset import Case, CaseStore


def oversample_flags(batch_size: int, oversample_percent: float = 0.33
                     ) -> list[bool]:
    """Sample i is foreground-forced iff i >= round(batch*(1-p))
    (`nnUNetTrainer.py:371-376` exact rounding semantics)."""
    cutoff = round(batch_size * (1 - oversample_percent))
    return [i >= cutoff for i in range(batch_size)]


def cascade_component_dropout(prev: np.ndarray, rng: np.random.RandomState,
                              p: float = 0.2,
                              max_coverage: float = 0.15) -> np.ndarray:
    """Remove one random connected component per foreground label with
    probability `p` (cascade robustness noise).

    Parity: `RemoveRandomConnectedComponentFromOneHotEncodingTransform`
    at apply_probability 0.2 with dont_do_if_covers_more_than_x_percent
    0.15 (`nnUNetTrainer.py:820-828`) — a component is only dropped when
    it covers <= 15% of the patch. Runs on the HOST label patch before
    upload (connected components are host work; the one-hot split happens
    on device in `augment_batch_cascade`).
    """
    from scipy import ndimage

    out = None
    limit = max_coverage * prev.size
    for lb in np.unique(prev):
        if lb <= 0 or rng.uniform() >= p:
            continue
        mask = prev == lb
        comps, n = ndimage.label(mask)
        if n == 0:
            continue
        pick = 1 + rng.randint(n)
        comp = comps == pick
        if comp.sum() > limit:
            continue
        if out is None:
            out = np.array(prev)
        out[comp] = 0
    return prev if out is None else out


class DataLoader:
    """Yields (data (N,X,Y,Z,C) fp32, seg (N,X,Y,Z) int32) numpy batches in
    the channels-last layout the network consumes; with `part=(i, k)` the
    i-th of k equal parts of each batch of `batch_size` rows."""

    def __init__(self, store: CaseStore, patch_size: tuple[int, int, int],
                 batch_size: int, oversample_percent: float = 0.33,
                 seed: int = 0, case_ids: list[str] | None = None,
                 cache_cases: bool = True,
                 probabilistic_oversampling: bool = False,
                 cascade: bool = False,
                 cascade_cc_dropout_p: float = 0.2,
                 part: tuple[int, int] | None = None):
        self.store = store
        self.patch_size = tuple(patch_size)
        self.batch_size = batch_size
        i, k = part or (0, 1)
        if batch_size % k or not 0 <= i < k:
            raise ValueError(f"part {part} of a batch of {batch_size}")
        n = batch_size // k
        self.rows = range(i * n, (i + 1) * n)
        # positional round rule by default; the probabilistic variant
        # (`nnUNetTrainer_probabilisticOversampling`, data_loader.py:65-77)
        # draws a Bernoulli(percent) per sample instead
        self.probabilistic = probabilistic_oversampling
        self.oversample_percent = float(oversample_percent)
        self.oversample = oversample_flags(batch_size, oversample_percent)
        self.rng = np.random.RandomState(seed)
        self.case_ids = case_ids if case_ids is not None else store.case_ids()
        if not self.case_ids:
            raise ValueError("empty case store")
        self._cache: dict[str, Case] = {}
        self.cache_cases = cache_cases
        # cascade mode: batches carry the previous-stage seg patch as a
        # third array (same crop as data/seg), with the host-side random
        # component dropout applied (see cascade_component_dropout)
        self.cascade = cascade
        self.cascade_cc_dropout_p = cascade_cc_dropout_p
        if cascade and not store.has_prev_segs():
            raise ValueError(
                "cascade DataLoader needs a previous-stage segmentation "
                "(*_prevseg.npy) for every case — run "
                "boa_tpu_torch.train.cascade.predict_next_stage first")

    # ------------------------------------------------------------------
    def _case(self, cid: str) -> Case:
        if self.cache_cases and cid in self._cache:
            return self._cache[cid]
        c = self.store.load_case(cid)
        if self.cache_cases:
            self._cache[cid] = c
        return c

    def _sample_patch(self, case: Case, force_fg: bool, keep: bool = True
                      ) -> tuple[np.ndarray, np.ndarray]:
        """(data, seg, prev seg or None) of a random patch of `case`; with
        `keep` False only its draws are made (None for data and seg)."""
        data, seg = case.data, case.seg
        shape = seg.shape
        ps = self.patch_size
        need = [max(0, ps[i] - shape[i]) for i in range(3)]
        lbs = [-need[i] // 2 for i in range(3)]
        ubs = [shape[i] + need[i] // 2 + need[i] % 2 - ps[i] for i in range(3)]

        sel_center = None
        if force_fg:
            eligible = [k for k, v in case.class_locations.items() if len(v)]
            if eligible:
                cls = eligible[self.rng.choice(len(eligible))]
                locs = case.class_locations[cls]
                sel_center = locs[self.rng.choice(len(locs))]
        if sel_center is not None:
            bbox_lbs = [max(lbs[i], int(sel_center[i]) - ps[i] // 2)
                        for i in range(3)]
        else:
            bbox_lbs = [self.rng.randint(lbs[i], ubs[i] + 1) for i in range(3)]
        bbox_ubs = [bbox_lbs[i] + ps[i] for i in range(3)]

        # valid region inside the case
        vlb = [max(0, bbox_lbs[i]) for i in range(3)]
        vub = [min(shape[i], bbox_ubs[i]) for i in range(3)]
        sl = tuple(slice(vlb[i], vub[i]) for i in range(3))
        ins = tuple(slice(vlb[i] - bbox_lbs[i], vub[i] - bbox_lbs[i])
                    for i in range(3))
        dpatch = spatch = None
        if keep:
            dpatch = np.zeros((data.shape[0], *ps), np.float32)
            spatch = np.full(ps, -1, np.int32)  # oob seg = -1 (reference pad)
            dpatch[(slice(None), *ins)] = data[(slice(None), *sl)]
            spatch[ins] = seg[sl]
        if not self.cascade:
            return dpatch, spatch, None
        # the dropout's draws depend on the labels: made for every row
        ppatch = np.zeros(ps, np.int32)  # oob prev seg = background
        ppatch[ins] = case.prev_seg[sl]
        if self.cascade_cc_dropout_p > 0:
            ppatch = cascade_component_dropout(
                ppatch, self.rng, p=self.cascade_cc_dropout_p)
        return dpatch, spatch, ppatch

    def next_batch(self):
        """(x, y) batches — or (x, y, prev_seg) in cascade mode."""
        ps = self.patch_size
        n_ch = self._case(self.case_ids[0]).data.shape[0]
        n = len(self.rows)
        x = np.empty((n, *ps, n_ch), np.float32)
        y = np.empty((n, *ps), np.int32)
        prev = np.empty((n, *ps), np.int32) if self.cascade else None
        for row in range(self.batch_size):
            cid = self.case_ids[self.rng.randint(len(self.case_ids))]
            force_fg = (self.rng.uniform() < self.oversample_percent
                        if self.probabilistic else self.oversample[row])
            keep = row in self.rows
            dp, sp, pp = self._sample_patch(self._case(cid), force_fg, keep)
            if not keep:
                continue
            i = row - self.rows.start
            x[i] = np.moveaxis(dp, 0, -1)
            # out-of-bounds seg padding (-1) becomes background before the
            # loss, like the reference's RemoveLabelTransform(-1, 0) first
            # transform — a -1 target would gather the LAST class's log-prob
            # in the CE term (negative indices wrap) and train padded
            # voxels toward an arbitrary foreground class
            y[i] = np.maximum(sp, 0)
            if prev is not None:
                prev[i] = pp
        if prev is not None:
            return x, y, prev
        return x, y

    # ------------------------------------------------------------------
    def __iter__(self) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        while True:
            yield self.next_batch()

    def prefetched(self, depth: int = 2, pin: bool = False) -> Iterator[tuple]:
        """Background-thread prefetch (replaces MultiThreadedAugmenter); with
        `pin` each batch arrives as pinned CPU tensors, ready for
        `to_device`."""
        q: queue.Queue = queue.Queue(maxsize=depth)
        stop = threading.Event()

        def producer() -> None:
            # build each batch ONCE and retry putting the same object:
            # re-sampling on queue.Full would burn the single host core at
            # steady state and make the RNG stream consumer-timing-dependent
            while not stop.is_set():
                batch = self.next_batch()
                if pin:
                    batch = tuple(torch.from_numpy(a).pin_memory() for a in batch)
                while not stop.is_set():
                    try:
                        q.put(batch, timeout=1.0)
                        break
                    except queue.Full:
                        continue

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                yield q.get()
        finally:
            stop.set()


def to_device(batch, device) -> tuple[torch.Tensor, ...]:
    """A batch (numpy arrays or pinned tensors) on `device`; pinned tensors
    travel with ``non_blocking=True``."""
    out = []
    for a in batch:
        t = torch.as_tensor(a)
        out.append(t.to(device, non_blocking=t.is_pinned()))
    return tuple(out)
