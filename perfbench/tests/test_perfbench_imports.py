"""No JAX in a run: the check that ``run.py`` makes once the window has
closed, and the harness's own imports.  The reference, the yardstick and
the traffic import nothing of the program either."""
import ast
import subprocess
import sys

import pytest

from perfbench.tests import _tiny
from perfbench import run

INDEPENDENT = ("lib/reftrain.py", "lib/check.py", "lib/cost.py",
               "lib/traffic.py", "lib/device_trace.py", "lib/registry.py",
               "reference/dense.py", "reference/ssm.py")


@pytest.mark.parametrize("modules,found", [
    ({"repro_torch": 1, "repro_torch.core.trainer": 1, "torch": 1}, []),
    ({"repro": 1}, ["repro"]),
    ({"repro.core.trainer": 1, "repro_torch": 1}, ["repro"]),
    ({"jax._src.core": 1}, ["jax"]),
    ({"jaxlib": 1, "flax.linen": 1}, ["flax", "jaxlib"]),
    ({"reproducible": 1, "jaxtyping": 1}, []),
])
def test_top_level_names_are_compared_whole(modules, found):
    assert run.forbidden_modules(modules) == found


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("rel", INDEPENDENT)
def test_reference_and_yardstick_import_nothing_of_the_program(rel):
    path = _tiny.ROOT / "perfbench" / rel
    tops = {name.split(".")[0] for name in _imports(path)}
    assert not tops & {"repro_torch", "repro", "jax", "jaxlib", "flax"}


def test_a_run_loads_no_jax():
    code = (
        "import sys; sys.path[:0] = ['src', '.']\n"
        "from perfbench.lib import bench, program, registry, reftrain\n"
        "from perfbench import run, calibrate\n"
        "cell = registry.cell('mamba2.train512.churn16')\n"
        "for m in cell.per_layer: cell.metric_module(m['name'])\n"
        "print(run.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=_tiny.ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_no_card_no_result():
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "danube-12L.train4k.churn16", "--seed", str(2 ** 31 + 7),
         "--seconds", "1", "--trace", "0"], cwd=_tiny.ROOT,
        capture_output=True, text=True, timeout=300,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    if "needs 1 CUDA device" not in out.stderr:
        pytest.skip("this machine has a card")
    assert out.returncode == 2 and out.stdout == ""
