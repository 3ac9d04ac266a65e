"""The control of `correct` at a size the CPU holds: the reference in float8
in the program's place must fail a limit that the program's sound runs keep.
On the card, at the cells' own sizes: `python3 perfbench/control.py
--workload <cell> --seeds a b c` (PERF.md gives the readings)."""

import time

import pytest

from perfbench import control, harness
from perfbench.tests import tiny


@pytest.mark.parametrize("seed", [11, 2 ** 31 + 5])
def test_control_fails_and_program_holds(tmp_path, seed):
    root = tiny.make_root(tmp_path)
    lim = tiny.config()["limits"]
    program = harness.run_cell(root, "tiny.mix", seed, 1.0, False, "cpu",
                               time.perf_counter())["checked"]
    low = control.control_readings(root, "tiny.mix", seed, "cpu")
    assert all(program[k] <= v for k, v in lim.items()), program
    assert any(low[k] > v for k, v in lim.items()), low
    assert low["gap_p999"] > 3 * program["gap_p999"]


@pytest.mark.gpu
def test_control_on_the_card(tmp_path):
    """The control at the study cell's own sizes (skips without a card)."""
    import json
    from pathlib import Path

    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    repo = Path(__file__).resolve().parents[2]
    cfg = json.loads((repo / "perfbench/configs/ts_total.json").read_text())
    low = control.control_readings(repo, "ts_total.study", 2 ** 31 + 7, "cuda")
    assert any(low[k] > v for k, v in cfg["limits"].items()), low
