"""BENCHMARK.json against the contract's shape rules, and every cell's,
mix's and metric's file found by name."""

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and ".." not in p
        assert (ROOT / p).is_dir()
    assert len(BENCH["command"]) <= 32
    assert all(1 <= len(w) <= 200 and not w.startswith("/") for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51


def test_full_check_fits_the_day():
    """24 cells at this window: 2 + 14 runs a cell, each with 60 s spare,
    180 s of compile a cell and 1200 s held back, within 43200 s."""
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_names_units_and_entry_keys():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and len(c["reduced"]) <= 16
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"] and "\t" not in w["why"]
        names.append(w["name"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                                                  "higher")
        names.append(m["name"])
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert 1 <= len(m["layer"]) <= 200
    assert len(names) == len(set(names))
    assert {m["name"]: m["bound"] for m in BENCH["end_to_end"]}["setup_s"] == 0.25
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_resolve_by_name(cell):
    w = {c["name"]: c for c in BENCH["workloads"]}[cell]
    cfg = {c["name"]: c for c in BENCH["configs"]}[w["config"]]
    assert cfg["file"] == f"portbench/configs/{w['config']}.json"
    config = json.loads((ROOT / cfg["file"]).read_text())
    assert config["name"] == w["config"] and config["source"] == cfg["source"]
    mix = json.loads((ROOT / "portbench" / "traffic" / f"{w['traffic']}.json").read_text())
    assert mix["mode"] in ("closed", "open")
    limits = json.loads((ROOT / "portbench" / "limits" / f"{cell}.json").read_text())
    assert limits["compared"] and all(k in limits for k in limits["compared"])
    e2e = [m["name"] for m in BENCH["end_to_end"] if cell in m.get("workloads", [cell])]
    layer = [m for m in BENCH["per_layer"] if cell in m.get("workloads", [cell])]
    assert "setup_s" in e2e and len(e2e) >= 2 and layer
    for m in layer:
        assert m["moves"] in e2e
        src = (ROOT / "portbench" / "metrics" / f"{m['name']}.py").read_text()
        assert "def read(ctx)" in src


def test_every_config_is_used():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}


def test_no_reduced_key_is_a_width():
    width = re.compile(r"(hidden|intermediate|latent|state|proj|head|expan|_dim$|_rank$|"
                       r"channels|d_model|d_ff|d_kv)")
    for c in BENCH["configs"]:
        assert not [k for k in c["reduced"] if width.search(k)]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_family_serves_its_mode(cell):
    """The configuration's family module is found by name and serves the
    mode of the cell's mix."""
    from portbench import run

    w = {c["name"]: c for c in BENCH["workloads"]}[cell]
    config = json.loads((ROOT / "portbench" / "configs" / f"{w['config']}.json").read_text())
    mix = json.loads((ROOT / "portbench" / "traffic" / f"{w['traffic']}.json").read_text())
    name = config.get("family", run.DEFAULT_FAMILY)
    assert (ROOT / "portbench" / "families" / f"{name}.py").is_file()
    fam = run.family(config, mix["mode"])
    for fn in ("make_weights", "build", "request", "reference_weights", "reference_latents",
               "reference_video"):
        assert callable(getattr(fam, fn))
    assert mix["mode"] != "open" or callable(fam.Served)
