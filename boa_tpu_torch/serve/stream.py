"""Pipelined PACS-style study stream on one card.

Counterpart of `boa_tpu/serve/stream.py` (BASELINE config #5: "32
concurrent DICOM series, end-to-end throughput"). The reference's answer
upstream is N Celery workers with one study each; here one process keeps
the card busy by overlapping the host work of study k+1 (NIfTI decode) and
of study k-1 (writing its labels) with the device work of study k: decoding
and writing run on host threads, `predict_image` on the calling thread on
the card. Reports CT volumes per minute.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Iterable

from boa_tpu_torch.device import resolve_device
from boa_tpu_torch.inference.pipeline import predict_image
from boa_tpu_torch.io import nifti
from boa_tpu_torch.weights.store import ModelStore

logger = logging.getLogger(__name__)


@dataclass
class StreamStats:
    n_studies: int = 0
    total_s: float = 0.0
    per_study_s: list = field(default_factory=list)

    @property
    def volumes_per_min(self) -> float:
        return self.n_studies / self.total_s * 60.0 if self.total_s else 0.0


@dataclass
class StudyJob:
    study_id: str
    input_path: Path | None = None         # NIfTI path, or
    image: nifti.NiftiImage | None = None  # pre-loaded image
    output_dir: Path | None = None


class StreamRunner:
    """Pipelined study-stream executor on `device` (the card by default).

    decode (host thread) -> predict (calling thread, on the device) -> write
    (host thread). Queues of depth 2 keep one study in flight per stage,
    like the reference's bounded tile queue (`predict_from_raw_data.py:580`)
    lifted to study granularity.
    """

    def __init__(self, store: ModelStore | None = None,
                 task: str = "total", fast: bool = True,
                 write_outputs: bool = True,
                 fake_predict: Callable | None = None,
                 decode_depth: int = 2, bucket: int | None = 64,
                 device=None):
        self.store = store or ModelStore()
        self.task = task
        self.fast = fast
        self.write_outputs = write_outputs
        self.fake_predict = fake_predict
        self.decode_depth = decode_depth
        # the reference's shape buckets: a mixed-series stream reuses the
        # padded model-grid shapes, and with them the allocator's blocks
        # and cuDNN's algorithm choices
        self.bucket = bucket
        self.device = resolve_device(device)

    def run(self, jobs: Iterable[StudyJob], num_parts: int = 1,
            part_id: int = 0) -> StreamStats:
        """`num_parts`/`part_id` shard the job list across workers like the
        reference predictor's file-level sharding
        (`predict_from_raw_data.py:918-925`: `files[part_id::num_parts]`).
        A study that fails to decode, predict or save fails its own job
        alone (logged); `n_studies` counts the predicted ones."""
        jobs = list(jobs)[part_id::num_parts]
        decoded: queue.Queue = queue.Queue(maxsize=self.decode_depth)
        results: queue.Queue = queue.Queue(maxsize=self.decode_depth)
        stats = StreamStats()
        t_start = time.perf_counter()

        def decoder() -> None:
            # the None sentinel goes out in a finally: a corrupt study must
            # fail its job, not strand the main loop on decoded.get()
            try:
                for job in jobs:
                    try:
                        img = job.image if job.image is not None else nifti.load(job.input_path)
                    except Exception:
                        logger.exception("study %s failed to decode", job.study_id)
                        continue
                    decoded.put((job, img))
            finally:
                decoded.put(None)

        def writer() -> None:
            # per-item try: a failing save must not kill the thread (the
            # bounded results queue would then fill and deadlock run())
            while True:
                item = results.get()
                if item is None:
                    return
                job, res = item
                try:
                    if self.write_outputs and job.output_dir is not None:
                        out = Path(job.output_dir)
                        out.mkdir(parents=True, exist_ok=True)
                        nifti.save(res.seg, out / f"{self.task}.nii.gz")
                except Exception:
                    logger.exception("study %s failed to save", job.study_id)

        td = threading.Thread(target=decoder, daemon=True)
        tw = threading.Thread(target=writer, daemon=True)
        td.start()
        tw.start()
        try:
            while True:
                item = decoded.get()
                if item is None:
                    break
                job, img = item
                t0 = time.perf_counter()
                try:
                    res = predict_image(img, self.task, self.store, fast=self.fast,
                                        bucket=self.bucket, fake_predict=self.fake_predict,
                                        device=self.device)
                except Exception:
                    # a failing study must not stall the stream (the PACS
                    # worker logs and continues, celery_task.py:221-225)
                    logger.exception("study %s failed", job.study_id)
                    continue
                dt = time.perf_counter() - t0
                stats.per_study_s.append(dt)
                stats.n_studies += 1
                logger.info("study %s: %.2fs", job.study_id, dt)
                results.put((job, res))
        finally:
            results.put(None)
            tw.join()
        stats.total_s = time.perf_counter() - t_start
        return stats
