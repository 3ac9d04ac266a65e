"""The import rule: nothing the harness loads is JAX, jaxlib, flax or the JAX
package (top-level names compared whole), and the reference and the network
families load nothing of the port."""

import ast
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
BENCH = REPO / "perfbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "boa_tpu"}


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
    return out


def _sources():
    return [p for p in BENCH.rglob("*.py") if "tests" not in p.relative_to(BENCH).parts]


def test_no_jax_in_the_harness_sources():
    for p in _sources():
        assert not (_imports(p) & FORBIDDEN), p


def test_reference_imports_nothing_of_the_port():
    for p in [*(BENCH / "reference").rglob("*.py"), *(BENCH / "nets").rglob("*.py")]:
        assert "boa_tpu_torch" not in _imports(p), p
        assert not (_imports(p) & FORBIDDEN), p


def test_loaded_modules_of_a_run():
    """What a run imports, the program's serving path, every front and every
    family with it, holds no JAX-side module by whole top-level name (the
    port's own name begins with the JAX package's)."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from perfbench import harness, control, trace\n"
        "from perfbench.work import roofline\n"
        "import boa_tpu_torch.python_api, boa_tpu_torch.inference.pipeline\n"
        "import boa_tpu_torch.ops.rowconv, boa_tpu_torch.ops.pallas_conv\n"
        "import torch.profiler\n"
        "for m in sorted(harness.BENCH.glob('metrics/*.py')):\n"
        "    harness.metric_reader(m.stem)\n"
        "for kind in ('fronts', 'nets'):\n"
        "    for m in sorted(harness.BENCH.glob(kind + '/[!_]*.py')):\n"
        "        harness.find(harness.BENCH.parent, kind, m.stem)\n"
        "print(harness.forbidden_modules())\n" % str(REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
