"""`run.py` without a card, and a whole run on the CPU at a tiny size from a
throwaway mix written under tmp_path."""

import os
import subprocess
import sys
import time
from pathlib import Path

from perfbench import harness
from perfbench.tests import tiny

REPO = Path(__file__).resolve().parents[2]


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                          "ts_total.study", "--seed", "2147483701", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, cwd=REPO,
                         env=env, timeout=300)
    assert out.returncode != 0
    assert out.stdout == ""
    assert "CUDA" in out.stderr


def test_a_throwaway_mix_runs(tmp_path):
    mix = tiny.traffic(name="throwaway", check_studies=1)
    root = tiny.make_root(tmp_path, mix=mix)
    r = harness.run_cell(root, "tiny.mix", 2 ** 31 + 17, 1.0, False, "cpu",
                         time.perf_counter())
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] >= 2
    assert set(r["metrics"]) == {"setup_s", "studies_per_h"}   # p90 needs ten studies
    assert list(r)[-1] == "checks"
    assert r["checks"]["label_faults"]["value"] == 0


def test_same_seed_same_inputs(tmp_path):
    root = tiny.make_root(tmp_path)
    for d in "abc":
        (tmp_path / d).mkdir()
    a = harness.Setup(root, "tiny.mix", 99, "cpu", tmp_path / "a")
    b = harness.Setup(root, "tiny.mix", 99, "cpu", tmp_path / "b")
    c = harness.Setup(root, "tiny.mix", 100, "cpu", tmp_path / "c")
    assert all((x == y).all() for x, y in zip(a.cts, b.cts))
    assert all((a.params[0][k] == b.params[0][k]).all() for k in a.params[0])
    assert not (a.cts[0] == c.cts[0]).all()
    assert harness.job_order(a.traffic, 99, 3) != harness.job_order(a.traffic, 100, 3)
    assert sorted(harness.job_order(a.traffic, 99, 3)) == sorted(
        harness.job_order(a.traffic, 100, 3))
