"""One run of one cell: set-up, the measured window, the traced window, the
check against the plain reference, and the result line.

Everything that belongs to a cell is found by name: the cell in
`BENCHMARK.json`, its configuration file (`configs/<config>.json`, the
manifest's `file`), its traffic mix (`traffic/<mix>.json`), one reader per
metric (`metrics/<metric>.py`, a `read(art)` returning a number or None),
the configuration's front door (`fronts/<program.front>.py`: how the
program runs one study and how the reference judges what it wrote) and its
network family (`nets/<network.family, lowercased>.py`: the seeded leaves,
the plans' architecture block, the plain reference's forward and the work
counts). This module holds no branch on a cell, a mix, a metric, a front or
a family.

The program under test is `boa_tpu_torch`: the window drives the front's
entry point over a backlog of phantom studies written as `.nii` files, one
study at a time as a worker of concurrency 1 does. The benchmark's clock
runs around each call and around the whole backlog.
"""

from __future__ import annotations

import importlib.util
import json
import logging
import shutil
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from perfbench import phantom, weights
from perfbench.reference import nifti as ref_nifti
from perfbench.reference import study as ref_study

BENCH = Path(__file__).resolve().parent


# --- finding things by name ----------------------------------------------------

def load_manifest(root: Path) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def cell(manifest: dict, workload: str) -> tuple[dict, dict]:
    """(workload entry, configuration entry) of a cell."""
    for w in manifest["workloads"]:
        if w["name"] == workload:
            for c in manifest["configs"]:
                if c["name"] == w["config"]:
                    return w, c
            raise KeyError(f"cell {workload!r} names no configuration {w['config']!r}")
    raise KeyError(f"no cell {workload!r} in BENCHMARK.json")


def load_config(root: Path, entry: dict) -> dict:
    return json.loads((Path(root) / entry["file"]).read_text())


def load_traffic(root: Path, mix: str) -> dict:
    return json.loads((Path(root) / "perfbench" / "traffic" / f"{mix}.json").read_text())


def find(root: Path, kind: str, name: str):
    """The module `perfbench/<kind>/<name>.py` of the checkout `root`, or of
    this benchmark where `root` has none (a root that adds only data files)."""
    path = Path(root) / "perfbench" / kind / f"{name}.py"
    if not path.is_file():
        path = BENCH / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench_{kind}_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, root: Path = BENCH.parent):
    return find(root, "metrics", name).read


def metrics_of(manifest: dict, workload: str, key: str) -> list[dict]:
    """The cell's metrics of one list (`end_to_end` or `per_layer`)."""
    return [m for m in manifest[key]
            if "workloads" not in m or workload in m["workloads"]]


# --- traffic -------------------------------------------------------------------

def _subseed(seed: int, *path: int) -> int:
    return int(np.random.SeedSequence([seed % 2 ** 64, *path]).generate_state(1)[0])


def study_affine(shape, spacing) -> np.ndarray:
    """The phantoms' affine: LPS voxel axes (x and y flipped against RAS),
    as a CT converted from DICOM comes."""
    a = np.diag([-spacing[0], -spacing[1], spacing[2], 1.0])
    a[:3, 3] = (shape[0] * spacing[0] / 2, shape[1] * spacing[1] / 2,
                -shape[2] * spacing[2] / 2)
    return a


def job_order(traffic: dict, seed: int, n_blocks: int) -> list[int]:
    """Phantom indices of the backlog: `n_blocks` blocks, each every phantom
    once, in an order drawn from the seed (the same work for every seed)."""
    rng = np.random.default_rng(_subseed(seed, 1))
    n = len(traffic["phantoms"])
    return [int(i) for _ in range(n_blocks) for i in rng.permutation(n)]


# --- the run --------------------------------------------------------------------

class Setup:
    """The seeded weights and their store, and the phantoms, of one cell; the
    program is called through `segment`."""

    def __init__(self, root: Path, workload: str, seed: int, device, work: Path):
        t0 = time.perf_counter()
        self.manifest = load_manifest(root)
        self.workload, centry = cell(self.manifest, workload)
        self.cfg = load_config(root, centry)
        self.traffic = load_traffic(root, self.workload["traffic"])
        self.front = find(root, "fronts", self.cfg["program"]["front"])
        self.family = find(root, "nets", self.cfg["network"]["family"].lower())
        self.seed, self.device, self.work = seed, torch.device(device), work
        gen = torch.Generator(device=self.device)
        gen.manual_seed(_subseed(seed, 0))
        self.params = []      # host leaves of each model, for the store and the reference
        for m in self.cfg["models"]:
            tree = weights.make_params(
                self.family.leaf_specs(self.cfg["network"], int(m["num_classes"])), gen,
                self.device, self.cfg["head_bias"], int(m["task_id"]))
            self.params.append(weights.flatten(tree))
            del tree
        self.store = self.front.write_store(self)
        t1 = time.perf_counter()
        self.cts, self.affines, self.paths = [], [], []
        (work / "in").mkdir()
        for i, p in enumerate(self.traffic["phantoms"]):
            shape, spacing = tuple(p["shape"]), tuple(p["spacing"])
            ct = phantom.synth_ct(shape, spacing, float(self.traffic["noise_hu"]),
                                  _subseed(seed, 2, i))
            aff = study_affine(shape, spacing)
            path = work / "in" / f"p{i}.nii"
            ref_nifti.write(path, ct, aff)
            self.cts.append(ct)
            self.affines.append(aff)
            self.paths.append(path)
        self.n_jobs = 0
        self.phases = {"weights_store_s": t1 - t0, "phantoms_s": time.perf_counter() - t1}

    def jobs(self, order: list[int], tag: str) -> list[tuple[int, Path]]:
        """(phantom index, output file) of each study of `order`."""
        out = []
        for i in order:
            self.n_jobs += 1
            out.append((i, self.work / "out" / f"{tag}{self.n_jobs}" / self.front.output_name))
        return out

    def segment(self, i: int, output: Path, spans: dict | None = None) -> None:
        self.front.segment(self, i, output, spans)

    def timed_run(self, jobs: list) -> dict:
        """The backlog, one study after another, on the benchmark's clock."""
        study_s, done = [], 0
        t0 = time.perf_counter()
        for i, output in jobs:
            t = time.perf_counter()
            try:
                self.segment(i, output)
                done += 1
            except Exception:   # a failed study fails its own job; counted below
                logging.getLogger(__name__).exception("study %s failed", output)
            study_s.append(time.perf_counter() - t)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return {"run_s": time.perf_counter() - t0, "study_s": study_s, "done": done,
                "attempted": len(jobs)}


def _warm_up(s: Setup) -> None:
    """One study of every distinct phantom shape, written where the window's
    are."""
    first: dict = {}
    for i, p in enumerate(s.traffic["phantoms"]):
        first.setdefault((tuple(p["shape"]), tuple(p["spacing"])), i)
    s.timed_run(s.jobs(list(first.values()), "w"))


def backlog_blocks(traffic: dict, seconds: float) -> int:
    """Blocks of the window's backlog: `seconds` over the mix's stated seconds
    of one block (`block_s`), so that every run does the same work."""
    return max(1, int(round(seconds / float(traffic["block_s"]))))


def _traced(s: Setup, order: list[int]) -> dict:
    """The traced window under the profiler, then the program's spans of the
    same studies through the front's `segment(spans=...)`, with the
    benchmark's clock around each call."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from boa_tpu_torch.ops import pallas_conv, rowconv
    from perfbench import trace

    jobs = s.jobs(order, "t")
    rowconv.reset_launches()
    pallas_conv.reset_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(trace.WINDOW):
            window = s.timed_run(jobs)
    launches = {**rowconv.LAUNCHES, **pallas_conv.LAUNCHES}
    tr = trace.read(prof)
    del prof
    spans = []
    for i, output in s.jobs(order, "p"):
        sp: dict = {}
        t = time.perf_counter()
        s.segment(i, output, spans=sp)
        sp["call_s"] = time.perf_counter() - t
        spans.append(sp)
    return {"jobs": jobs, "window": window, "trace": tr, "launches": launches,
            "spans": spans}


def _params_on(flat: dict, device) -> dict:
    tree: dict = {}
    for key in sorted(flat, key=lambda k: [int(p) if p.isdigit() else p
                                           for p in k.split("/")]):
        path = tuple(int(p) if p.isdigit() else p for p in key.split("/"))
        weights._tree_set(tree, path, torch.from_numpy(flat[key]).to(device))
    return tree


def pick_studies(s: Setup, jobs: list) -> list[int]:
    """Indices of the checked studies of `jobs`: the longest, then others
    drawn from the seed."""
    n_check = min(int(s.traffic["check_studies"]), len(jobs))
    sizes = [int(np.prod(s.traffic["phantoms"][i]["shape"])) for i, _ in jobs]
    longest = int(np.argmax(sizes))
    rest = [j for j in range(len(jobs)) if j != longest]
    rng = np.random.default_rng(_subseed(s.seed, 3))
    return [longest] + [int(j) for j in rng.choice(rest, n_check - 1, replace=False)]


def check(s: Setup, jobs: list) -> dict:
    """The reference's readings over a sample of the window's studies drawn
    from the seed, the longest among them, judged by the front."""
    pick = pick_studies(s, jobs)
    trees = [_params_on(p, s.device) for p in s.params]
    r = s.front.judge(s, [jobs[j] for j in pick], trees)
    out = ref_study.summarize(r["gaps"], r["label_faults"])
    out.update(missing=r["missing"], studies=len(pick))
    return out


def verdict(s: Setup, window: dict, readings: dict) -> tuple[bool, dict]:
    """Each compared number beside its limit, and whether all hold. The
    configuration's `limits` name the compared gap readings."""
    checks = {
        "unfinished": {"value": window["attempted"] - window["done"] + readings["missing"],
                       "limit": 0},
        "label_faults": {"value": readings["label_faults"], "limit": 0},
    }
    for name, limit in s.cfg["limits"].items():
        checks[name] = {"value": readings[name], "limit": limit}
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    return ok, checks


def run_cell(root: Path, workload: str, seed: int, seconds: float, traced: bool,
             device, t_start: float) -> dict:
    """The result line's object of one run (`t_start`: the process's start on
    `time.perf_counter`'s clock)."""
    work = Path(tempfile.mkdtemp(prefix="perfbench-"))
    try:
        s = Setup(Path(root), workload, seed, device, work)
        t0 = time.perf_counter()
        _warm_up(s)
        s.phases["warm_up_s"] = time.perf_counter() - t0
        cuda = s.device.type == "cuda"
        if cuda:
            torch.cuda.synchronize(s.device)
            torch.cuda.reset_peak_memory_stats(s.device)
        art = {"config": s.cfg, "family": s.family, "traffic": s.traffic,
               "setup_s": time.perf_counter() - t_start}
        if traced:
            order = job_order(s.traffic, seed, 1)[:int(s.traffic["trace_studies"])]
            art.update(_traced(s, order))
            key = "per_layer"
        else:
            order = job_order(s.traffic, seed, backlog_blocks(s.traffic, seconds))
            art["jobs"] = s.jobs(order, "s")
            art["window"] = s.timed_run(art["jobs"])
            key = "end_to_end"
        peak = int(torch.cuda.max_memory_allocated(s.device)) if cuda else 0
        art["memory_peak_bytes"] = peak
        metrics = {}
        for m in metrics_of(s.manifest, workload, key):
            v = metric_reader(m["name"], root)(art)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        window = art["window"]
        print(f"set-up {art['setup_s']:.3f} s: {s.phases}; window {window['run_s']:.3f} s, "
              f"studies {[round(t, 3) for t in window['study_s']]}", file=sys.stderr)
        if cuda:
            torch.cuda.empty_cache()
        readings = check(s, art["jobs"])
        ok, checks = verdict(s, window, readings)
        result = {
            "correct": ok, "attempted": window["attempted"],
            "failed": window["attempted"] - window["done"], "metrics": metrics,
            "device": {"platform": "gpu" if cuda else s.device.type,
                       "kind": torch.cuda.get_device_name(s.device) if cuda else "cpu",
                       "count": 1, "memory_peak_bytes": peak},
        }
        if traced:
            result["device"]["busy_s"] = art["trace"]["busy_s"]
            result["device"]["window_s"] = art["trace"]["window_s"]
            result["breakdown"] = {"device_ops": art["trace"]["device_ops"],
                                   "idle_gaps": art["trace"]["idle_gaps"]}
        result["checked"] = {k: readings[k] for k in
                             ("studies", "voxels", "gap_max", "gap_p999", "gap_mean",
                              "flip_share", "flip_gap_mean")}
        result["checks"] = checks
        return result
    finally:
        shutil.rmtree(work, ignore_errors=True)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX package's."""
    bad = {"jax", "jaxlib", "flax", "boa_tpu"}
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in bad)
