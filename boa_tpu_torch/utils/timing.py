"""Per-stage wall seconds.

Counterpart of `Spans` in `boa_tpu/utils/timing.py`, shared by
`predict_image`, the measurement engine and `compute_all_models`: each
mark waits for the device's queued work (`torch.cuda.synchronize`) before
it reads the clock, so a stage's seconds are its own and not the next
stage's. With no `out` dict the marks do nothing and never synchronize.
"""

from __future__ import annotations

import time

import torch


class Spans:
    """Per-stage wall seconds into `out` (when given), summed per label."""

    def __init__(self, out: dict | None, device: torch.device) -> None:
        self.out, self.device = out, torch.device(device)
        self.t = time.perf_counter()

    def mark(self, label: str) -> None:
        """Add the seconds since the last mark (or since the start) to `label`."""
        if self.out is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.add(label, now - self.t)
        self.t = now

    def restart(self) -> None:
        """Start the next span now (after work that other spans timed)."""
        self.t = time.perf_counter()

    def add(self, label: str, value) -> None:
        if self.out is not None:
            self.out[label] = self.out.get(label, 0) + value
