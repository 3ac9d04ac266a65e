"""The training benchmark: a few epochs on synthetic data, epoch times to
`benchmark_result.json`.

Counterpart of `boa_tpu/engine/benchmark.py` (`benchmark_training`,
`main`, `summarize_benchmark_results`; nnU-Net's
`nnUNetTrainerBenchmark_5epochs.py:10-40` and
`batch_running/benchmarking/summarize_benchmark_results.py`): the port's
train step (`train/trainer.py:make_train_step`: bf16 forward on float32
masters, deep supervision, Dice + CE, clip, SGD) on one fixed random batch,
one warm-up step, then `n_epochs` epochs of `iters_per_epoch` steps, each
epoch ending with one wait for the device (the loss read back, as the
reference's `float(m["loss"])`). The result keeps the reference's timing
keys; in place of its JAX version and backend it names the torch version
and the device (the card's name on the card).

    python -m boa_tpu_torch.engine.benchmark [--flagship] [--epochs N]
        [--iters N] [-o DIR] [-d cpu]

The default is nnU-Net's small benchmark (4 stages 16->128, 64^3, batch 2,
5 x 10 iterations); `--flagship` the production `total` network (6 stages
32->320, 128^3, batch 2, 25 classes, 3 x 20 iterations). It runs on the card
unless `-d cpu`.
"""

from __future__ import annotations

import json
import platform
import time
from pathlib import Path

import numpy as np
import torch

from boa_tpu_torch.device import named_device
from boa_tpu_torch.version import __version__


def benchmark_training(out_dir: str | Path, patch=(64, 64, 64), batch_size: int = 2,
                       num_classes: int = 5, features=(16, 32, 64, 128), n_epochs: int = 5,
                       iters_per_epoch: int = 10, seed: int = 0, device="gpu") -> dict:
    """Time `n_epochs` x `iters_per_epoch` train steps after one warm-up step;
    writes and returns `benchmark_result.json`'s dict. `device` takes the
    port's names ("gpu", "gpu:N", "cpu")."""
    from boa_tpu_torch.models.unet import ArchConfig
    from boa_tpu_torch.train.trainer import (TrainConfig, init_model, init_opt_state,
                                             make_train_step)

    dev = named_device(device)
    n = len(features)
    arch = ArchConfig(
        n_stages=n, features_per_stage=tuple(features), kernel_sizes=((3, 3, 3),) * n,
        strides=((1, 1, 1),) + ((2, 2, 2),) * (n - 1), n_conv_per_stage=(2,) * n,
        n_conv_per_stage_decoder=(2,) * (n - 1), num_classes=num_classes, input_channels=1,
        deep_supervision=True)
    cfg = TrainConfig(arch=arch)
    model = init_model(arch, seed, dev)
    optimizer = init_opt_state(cfg, model)
    step = make_train_step(cfg)
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((batch_size, *patch, 1), dtype=np.float32)).to(dev)
    y = torch.from_numpy(rng.integers(0, num_classes, (batch_size, *patch))).to(dev)
    float(step(model, optimizer, x, y, 1e-2)["loss"])   # warm-up

    epoch_times = []
    for _ in range(n_epochs):
        t0 = time.perf_counter()
        for _ in range(iters_per_epoch):
            m = step(model, optimizer, x, y, 1e-2)
        float(m["loss"])   # the epoch's one wait for the device
        epoch_times.append(time.perf_counter() - t0)

    result = {
        "boa_tpu_version": __version__,
        "torch_version": torch.__version__,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "platform": platform.platform(),
        "patch_size": list(patch),
        "batch_size": batch_size,
        "iters_per_epoch": iters_per_epoch,
        "epoch_times_s": epoch_times,
        "fastest_epoch_s": min(epoch_times),
        "it_per_s": iters_per_epoch / min(epoch_times),
    }
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "benchmark_result.json").write_text(json.dumps(result, indent=2))
    return result


FLAGSHIP = dict(patch=(128, 128, 128), num_classes=25, features=(32, 64, 128, 256, 320, 320),
                n_epochs=3, iters_per_epoch=20)


def main(argv: list[str] | None = None) -> None:
    """`python -m boa_tpu_torch.engine.benchmark`: prints one JSON line of
    the result's main keys and where the file went."""
    import argparse
    import tempfile

    ap = argparse.ArgumentParser(description="training epoch-time benchmark")
    ap.add_argument("-o", "--out-dir", default=None)
    ap.add_argument("--flagship", action="store_true",
                    help="6-stage 32..320 arch, 128^3 patch, 25 classes")
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--iters", type=int, default=None)
    ap.add_argument("-d", "--device", default="gpu",
                    help="gpu (default: the card), gpu:N, or cpu")
    args = ap.parse_args(argv)
    kw: dict = dict(FLAGSHIP) if args.flagship else {}
    if args.epochs is not None:
        kw["n_epochs"] = args.epochs
    if args.iters is not None:
        kw["iters_per_epoch"] = args.iters
    out = args.out_dir or tempfile.mkdtemp(prefix="boa_trainbench_")
    result = benchmark_training(out, device=args.device, **kw)
    print(json.dumps({k: result[k] for k in
                      ("torch_version", "device", "patch_size", "batch_size",
                       "iters_per_epoch", "fastest_epoch_s", "it_per_s")}))
    print(f"result written to {out}/benchmark_result.json")


def summarize_benchmark_results(folders: list[str | Path]) -> dict:
    """folder -> {device, fastest_epoch_s, it_per_s} of each folder that
    holds a benchmark_result.json."""
    rows = {}
    for f in folders:
        p = Path(f) / "benchmark_result.json"
        if p.exists():
            r = json.loads(p.read_text())
            rows[str(f)] = {"device": r.get("device"),
                            "fastest_epoch_s": r.get("fastest_epoch_s"),
                            "it_per_s": r.get("it_per_s")}
    return rows


if __name__ == "__main__":
    main()
