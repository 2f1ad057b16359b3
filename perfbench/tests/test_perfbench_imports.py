"""What a run loads, checked in a fresh interpreter by top-level module
name (the part before the first dot) compared whole: no ``jax`` and no
``repro`` (the JAX package; ``repro_torch`` begins with its name), and
in the plain reference not the program either."""
import json
import subprocess
import sys

from perfbench import harness

ROOT = harness.ROOT

RUN = r"""
import json, sys
sys.path[:0] = [{src!r}, {root!r}]
from perfbench import harness
from pathlib import Path
for p in sorted(Path({bench!r}).rglob("*.py")):
    if "tests" not in p.parts:
        harness.load_file(p)
from perfbench.tests import smoke
out = smoke.run_cpu("smollm-360m.train", seconds=0.2)
out = smoke.run_cpu("jamba2-mini.prefill", seconds=0.2)
print(json.dumps(sorted({{n.split(".")[0] for n in sys.modules}})))
"""

REFERENCE = r"""
import json, sys
sys.path[:0] = [{root!r}]
from perfbench.reference import check, common, jamba, llama
print(json.dumps(sorted({{n.split(".")[0] for n in sys.modules}})))
"""


def _top_names(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code.format(src=str(ROOT / "src"),
                                           root=str(ROOT),
                                           bench=str(harness.BENCH))],
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax_module():
    names = _top_names(RUN)
    assert "repro_torch" in names and "torch" in names
    assert not names & {"jax", "jaxlib", "flax", "repro"}


def test_the_reference_loads_neither_jax_nor_the_program():
    names = _top_names(REFERENCE)
    assert "torch" in names
    assert not names & {"jax", "jaxlib", "flax", "repro", "repro_torch"}


def test_forbidden_names_compare_whole():
    sys.modules.setdefault("repro_torch_probe_x", sys)
    try:
        assert "repro_torch_probe_x" not in harness.forbidden_modules()
    finally:
        del sys.modules["repro_torch_probe_x"]


def test_run_without_a_card_prints_no_result():
    out = subprocess.run(
        [sys.executable, str(harness.BENCH / "run.py"), "--workload",
         "smollm-360m.train", "--seed", str(2 ** 40 + 1), "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
