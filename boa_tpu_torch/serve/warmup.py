"""Pay the first-use costs of the serving path at deploy time.

Counterpart of `boa_tpu/serve/warmup.py`. On the card, the first study of a
fresh process pays for
- the build of the hand-written kernels (`csrc/*.cu`, one `nvcc` each, in
  parallel, into `build/boa_tpu_torch_kernels/<hash>/`; later processes
  load the cached libraries);
- the upload of each model's weights into the device weight cache;
- cuDNN's choice of algorithm for the eager layers at each new shape;
- the caching allocator's first blocks at each new shape.
Only the build outlives the process. `warmup_task` builds the kernels first
(`_build.build_all`), then runs one zero-HU study per bucketed model-grid
shape of a task, so that a deploy-time bake pays the build and a
long-lived worker serves its first clinical study warm. On an NVIDIA H100
80GB HBM3 at 700 W (`chip_smoke.py`'s serve phase, PERF.md) the build took
22-32 s, once per source hash; with it cached, a fresh process's first fast
`total` study of a 512x512x150 CT took 2.8-3.9 s and its second 0.19-0.23
s, and 0.34-0.43 s after a warm-up of its shape.

CLI:
    python -m boa_tpu_torch.serve.warmup --task total --fast \
        --xy 512 --z-range 200 600 [--bucket 64] [--spacing 1.5 1.5 3.0] [-d gpu]
    python -m boa_tpu_torch.serve.warmup --bake [--full] [--stamp FILE]
"""

from __future__ import annotations

import argparse
import logging
import time
from pathlib import Path

import numpy as np

from boa_tpu_torch import _build
from boa_tpu_torch.device import named_device, resolve_device
from boa_tpu_torch.inference.pipeline import predict_image
from boa_tpu_torch.io.nifti import NiftiImage
from boa_tpu_torch.tasks.registry import resolve_task
from boa_tpu_torch.weights.store import ModelStore

logger = logging.getLogger(__name__)


def warmup_task(store: ModelStore, task_name: str, *, fast: bool = False,
                xy: int | tuple[int, int] = 512,
                z_range: tuple[int, int] = (200, 600),
                bucket: int = 64,
                spacing: tuple[float, float, float] = (1.5, 1.5, 3.0),
                dtype: str = "bfloat16", device=None) -> list[float]:
    """Build the kernels (on the card), then run one zero-HU study per
    bucketed model-grid shape on `device` (the card by default); returns
    each shape's seconds.

    `xy` may be a (nx, ny) pair to warm a body-cropped in-plane extent. The
    zero-HU volume never triggers the body crop (0 HU is above its -500
    threshold everywhere), so the requested shape is the shape warmed."""
    device = resolve_device(device)
    if device.type == "cuda":
        _build.build_all()
    # resolved through the same helper predict_image uses
    task = resolve_task(task_name, fast=fast)
    nx, ny = (xy, xy) if isinstance(xy, int) else xy
    times = []
    for z_raw in _raw_z_for_buckets(task, spacing, z_range, bucket):
        vol = np.zeros((nx, ny, z_raw), np.int16)
        affine = np.diag([-spacing[0], -spacing[1], spacing[2], 1.0])
        img = NiftiImage(data=vol, affine=affine)
        t0 = time.perf_counter()
        predict_image(img, task_name, store, fast=fast, bucket=bucket, compute_dtype=dtype,
                      device=device)
        dt = time.perf_counter() - t0
        times.append(dt)
        logger.info("warmed z=%d in %.1fs", z_raw, dt)
    return times


def _raw_z_for_buckets(task, spacing, z_range, bucket) -> list[int]:
    """One representative raw z per distinct bucketed model-grid extent
    (the pipeline resamples spacing[2] to the task's z spacing, and the
    predictor pads the model grid to the bucket)."""
    resample = task.resample
    zf = 1.0 if resample is None else spacing[2] / resample[2]
    seen, out = set(), []
    for z in range(z_range[0], z_range[1] + 1):
        z_model = int(round(z * zf))
        zb = -(-max(z_model, 1) // bucket) * bucket
        if zb not in seen:
            seen.add(zb)
            out.append(z)
    return out


def bake(store: ModelStore, tasks: list[tuple[str, bool]] | None = None,
         *, xy: int = 512, z_range: tuple[int, int] = (200, 600),
         bucket: int = 64,
         spacing: tuple[float, float, float] = (1.5, 1.5, 3.0),
         stamp: str | None = None, full: bool = False, device=None) -> None:
    """Deploy-time warm-up over the serving task set: fast `total` and the
    two BCA models, plus with `full` their non-fast programs (the
    five-sub-model `total` and the 5-fold BCA models) at the uncropped FOV
    and the common body-crop extent. A task whose weights are missing is
    skipped with a warning. With `stamp`, an existing stamp file skips the
    bake (delete it to force), and a finished bake writes it."""
    if stamp:
        p = Path(stamp).expanduser()
        if p.exists():
            logger.info("warmup stamp %s present, skipping bake", p)
            return
    if tasks is None:
        tasks = [("total", True), ("body_regions", True), ("body_parts", True)]
        if full:
            tasks += [("total", False), ("body_regions", False), ("body_parts", False)]
    # in-plane extents: the uncropped FOV, plus with `full` the most common
    # body-crop bucket (a whole-torso 512 FOV crops to about 384 x 320)
    xys: list[int | tuple[int, int]] = [xy]
    if full and xy == 512:
        xys.append((384, 320))
    for name, fast in tasks:
        for shape_xy in (xys if not fast else xys[:1]):
            try:
                t = warmup_task(store, name, fast=fast, xy=shape_xy, z_range=z_range,
                                bucket=bucket, spacing=spacing, device=device)
                logger.info("baked %s xy=%s (%d shapes, %.1fs)", name, shape_xy,
                            len(t), sum(t))
            except FileNotFoundError as exc:  # weights not installed yet
                logger.warning("skipping bake of %s: %s", name, exc)
    if stamp:
        p = Path(stamp).expanduser()
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text("baked\n")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--task", default="total")
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--xy", type=int, default=512)
    ap.add_argument("--z-range", type=int, nargs=2, default=(200, 600))
    ap.add_argument("--bucket", type=int, default=64)
    ap.add_argument("--spacing", type=float, nargs=3, default=(1.5, 1.5, 3.0))
    ap.add_argument("--weights", default=None, help="weights root override")
    ap.add_argument("--bake", action="store_true",
                    help="warm the PACS task set (fast total + BCA)")
    ap.add_argument("--full", action="store_true",
                    help="with --bake: also warm the non-fast programs "
                    "(5-sub-model total + 5-fold BCA, cropped and uncropped "
                    "in-plane shapes)")
    ap.add_argument("--stamp", default=None,
                    help="stamp file: skip the bake when it exists")
    ap.add_argument("-d", "--device", default="gpu",
                    help="gpu (the card, default), gpu:N or cpu")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    device = named_device(args.device)
    store = ModelStore(args.weights)
    if args.bake:
        bake(store, xy=args.xy, z_range=tuple(args.z_range), bucket=args.bucket,
             spacing=tuple(args.spacing), stamp=args.stamp, full=args.full, device=device)
        return
    times = warmup_task(store, args.task, fast=args.fast, xy=args.xy,
                        z_range=tuple(args.z_range), bucket=args.bucket,
                        spacing=tuple(args.spacing), device=device)
    print(f"warmed {len(times)} bucketed shapes in {sum(times):.1f}s "
          f"({', '.join(f'{t:.2f}' for t in times)})")


if __name__ == "__main__":
    main()
