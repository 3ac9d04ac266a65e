"""The control of `correct`: the plain reference computed one precision below
the configuration's (float8 e4m3 operands for its bfloat16, `reference/unet.py`)
put in the program's place, judged by the same comparison as the program
(the front's `judge(..., fp8=True)`).

    python3 perfbench/control.py --workload <cell> --seeds <n> [<n> ...]

On the card, at the cell's own sizes: for each seed the cell's inputs and
weights, the studies that a run's check would sample from one block of its
backlog, the float32 reference, the control's labels (the argmax of its
fused logits, written as the program would write them), and the readings the
check compares. Prints one JSON line per seed. The program is
not run.
"""

import argparse
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def control_readings(root: Path, workload: str, seed: int, device) -> dict:
    from perfbench import harness
    from perfbench.reference import study

    work = Path(tempfile.mkdtemp(prefix="perfbench-control-"))
    try:
        s = harness.Setup(root, workload, seed, device, work)
        jobs = [(i, None) for i in harness.job_order(s.traffic, seed, 1)]
        picked = [jobs[j] for j in harness.pick_studies(s, jobs)]
        trees = [harness._params_on(p, s.device) for p in s.params]
        r = s.front.judge(s, picked, trees, fp8=True)
        return study.summarize(r["gaps"], r["label_faults"])
    finally:
        shutil.rmtree(work, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("the control runs on the card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    for seed in args.seeds:
        t0 = time.perf_counter()
        r = control_readings(ROOT, args.workload, seed, "cuda")
        r.update(workload=args.workload, seed=seed, seconds=time.perf_counter() - t0)
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
