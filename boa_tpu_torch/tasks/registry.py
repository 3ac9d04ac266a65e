"""Task registry: per-model inference configuration.

Counterpart of `boa_tpu/tasks/registry.py`, holding the entries this port
runs so far: `total` and its fast variant `total_fast` (task 297, 3 mm).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class TaskConfig:
    name: str
    task_ids: tuple[int, ...]
    # target spacing in mm; None = native spacing
    resample: tuple[float, float, float] | None
    trainer: str
    model: str = "3d_fullres"
    folds: tuple[int, ...] | None = (0,)
    # only resample slice thickness (z), keep in-plane spacing
    resample_only_thickness: bool = False
    keep_largest_blob: bool = False


def _iso(v: float) -> tuple[float, float, float]:
    return (v, v, v)


TASKS: dict[str, TaskConfig] = {
    "total": TaskConfig(
        name="total",
        task_ids=(291, 292, 293, 294, 295),
        resample=_iso(1.5),
        trainer="nnUNetTrainerNoMirroring",
    ),
    "total_fast": TaskConfig(
        name="total_fast",
        task_ids=(297,),
        resample=_iso(3.0),
        trainer="nnUNetTrainer_4000epochs_NoMirroring",
    ),
}

_FAST_VARIANTS = {"total": "total_fast"}


def get_task(name: str, fast: bool = False) -> TaskConfig:
    if name in _FAST_VARIANTS:
        return TASKS[_FAST_VARIANTS[name] if fast else name]
    if name in TASKS:
        if fast:
            raise ValueError(f"task {name} does not support the fast option")
        return TASKS[name]
    raise KeyError(f"unknown task {name!r}")


def resolve_task(name: str, fast: bool = False) -> TaskConfig:
    """Fast variants by kwarg for `total`; explicitly suffixed `*_fast`
    names resolve as they are."""
    if name == "total" or not name.endswith(("_fast", "_fastest")):
        return get_task(name, fast=fast)
    return get_task(name)
