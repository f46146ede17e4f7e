"""The control at a cell's own size, on the card (skips without one): the
program's first request passes the cell's limits and the reference in
float8 in the program's place fails them, on three seeds."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
SEEDS = ["2200000001", "2200000002", "2200000003"]


@pytest.mark.cuda
def test_control_fails_where_the_program_passes(card):
    cell = "ltx2b-t2v-97f"
    out = subprocess.run([sys.executable, "-m", "portbench.calibrate", "readings",
                          "--workload", cell, "--seeds", *SEEDS, "--control-seeds", *SEEDS],
                         cwd=ROOT, capture_output=True, text=True, timeout=1800)
    assert out.returncode == 0, out.stderr[-3000:]
    limits = json.loads((ROOT / "portbench" / "limits" / f"{cell}.json").read_text())
    lines = [json.loads(x) for x in out.stdout.splitlines() if x.startswith("{")]
    assert len(lines) == len(SEEDS)
    for line in lines:
        got, control = line["program"], line["fp8"]
        assert all(got[k] <= limits[k] for k in limits["compared"]), line
        assert any(control[k] > limits[k] for k in limits["compared"]), line
