"""Nothing the benchmark loads is JAX or the JAX package, compared by whole
top-level module names (the port's name begins with the JAX package's), and
the reference loads nothing of the program."""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "candle_video_tpu", "benches", "bench", "scripts"}

_RUN_TINY = """
import json, sys
from portbench import run
from portbench.tests import tiny
for name in ("ltx2b-t2v-97f", "ltx2b-serve-poisson"):
    cell, config, mix, limits, e2e, layer = tiny.cell(name)
    res = run.run_cell(cell, config, mix, limits, e2e, layer, 5, 1.0, True, "cpu", run.Phases())
    for m in layer:
        run.metric_reader(m["name"])
import portbench.calibrate
print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))
"""


def _top_level(code: str):
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=600, env={"PATH": "/usr/bin:/bin",
                                                      "HOME": str(ROOT)})
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_neither_jax_nor_the_jax_package():
    names = _top_level(_RUN_TINY)
    assert "candle_video_tpu_torch" in names
    assert not names & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    names = _top_level("import json, sys\nimport portbench.reference.ltx, portbench.weights, "
                       "portbench.traffic, portbench.arith\n"
                       "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    assert not names & (FORBIDDEN | {"candle_video_tpu_torch"})


def test_whole_name_comparison():
    from portbench import run

    assert set(run.FORBIDDEN) == FORBIDDEN
    assert "candle_video_tpu_torch" not in run.FORBIDDEN


def test_a_forbidden_module_loaded_late_is_found(monkeypatch):
    """The look runs just before the result is printed, after the metric
    readers and the reference have loaded, and compares whole names."""
    import types

    from portbench import run

    assert run.forbidden_loaded() == []
    monkeypatch.setitem(sys.modules, "scripts.tool", types.ModuleType("scripts.tool"))
    monkeypatch.setitem(sys.modules, "benchmarks", types.ModuleType("benchmarks"))
    assert run.forbidden_loaded() == ["scripts"]
