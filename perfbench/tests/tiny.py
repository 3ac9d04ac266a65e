"""A throwaway benchmark root at a size the CPU runs in seconds: a
3-stage PlainConvUNet (8-32 features, 32^3 patch, 3 mm) and a mix of two
small phantoms, written under a test's tmp_path beside a copy of the real
manifest's metric lists."""

from __future__ import annotations

import copy
import json
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

NET = {"family": "PlainConvUNet", "n_stages": 3, "features_per_stage": [8, 16, 32],
       "kernel_sizes": [[3, 3, 3]] * 3, "strides": [[1, 1, 1], [2, 2, 2], [2, 2, 2]],
       "n_conv_per_stage": [2, 2, 2], "n_conv_per_stage_decoder": [2, 2],
       "conv_bias": True, "norm_eps": 1e-5, "nonlin_slope": 0.01, "input_channels": 1}


def config() -> dict:
    base = json.loads((REPO / "perfbench/configs/ts_total_fast.json").read_text())
    base.update(name="tiny", network=NET, patch_size=[32, 32, 32], spacing=[3.0, 3.0, 3.0],
                limits={"gap_p999": 0.05, "flip_gap_mean": 0.02},
                head_bias={"sd": 0.3, "seed": 7, "background_lead": None})
    base["models"] = [dict(base["models"][0], num_classes=12)]
    return base


def traffic(**kw) -> dict:
    t = {"name": "tinymix", "users": "tests", "arrival": "backlog",
         "noise_hu": 10.0,
         "phantoms": [{"shape": [128, 192, 24], "spacing": [2.0, 2.0, 5.0]},
                      {"shape": [80, 64, 32], "spacing": [4.0, 4.0, 5.0]}],
         "why": "tests", "block_s": 1.0, "trace_studies": 2, "check_studies": 2}
    t.update(kw)
    return t


def make_root(tmp: Path, cfg: dict | None = None, mix: dict | None = None) -> Path:
    """tmp/BENCHMARK.json with one cell `tiny.mix` and its two data files."""
    cfg = cfg or config()
    mix = mix or traffic()
    manifest = json.loads((REPO / "BENCHMARK.json").read_text())
    m = copy.deepcopy(manifest)
    m["configs"] = [{"name": "tiny", "source": "tests", "file": "perfbench/configs/tiny.json",
                     "reduced": [], "why": "tests"}]
    m["workloads"] = [{"name": "tiny.mix", "config": "tiny", "traffic": mix["name"],
                       "chips": 1, "why": "tests"}]
    for key in ("end_to_end", "per_layer"):
        for x in m[key]:
            x.pop("workloads", None)
    (tmp / "perfbench/configs").mkdir(parents=True, exist_ok=True)
    (tmp / "perfbench/traffic").mkdir(parents=True, exist_ok=True)
    (tmp / "BENCHMARK.json").write_text(json.dumps(m))
    (tmp / "perfbench/configs/tiny.json").write_text(json.dumps(cfg))
    (tmp / f"perfbench/traffic/{mix['name']}.json").write_text(json.dumps(mix))
    return tmp
