"""The open mix's schedule comes from its ``schedule_seed`` alone: two
``--seed`` values offer the same requests at the same moments."""

import json
from pathlib import Path

from portbench import run, traffic
from portbench.tests import tiny

ROOT = Path(__file__).resolve().parents[2]
MIX = json.loads((ROOT / "portbench" / "traffic" / "serve-97f-poisson-fixed.json").read_text())


def test_arrivals_depend_on_the_schedule_seed_only():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    a = traffic.arrivals(MIX, bench["run_seconds"])
    assert a == traffic.arrivals(dict(MIX), bench["run_seconds"])
    assert all(0 < x < bench["run_seconds"] for x in a) and a == sorted(a)
    assert traffic.arrivals(dict(MIX, schedule_seed=MIX["schedule_seed"] + 1),
                            bench["run_seconds"]) != a
    # enough requests for a 95th percentile with one or two beyond it
    assert len(a) >= 30


def test_two_seeds_offer_the_same_schedule(capsys):
    cell, config, mix, limits, e2e, layer = tiny.cell("ltx2b-serve-poisson")
    due = traffic.arrivals(mix, 3.0)
    got = []
    for seed in (1, 2 ** 31 + 17):
        res = run.run_cell(cell, config, mix, limits, e2e, layer, seed, 3.0, False, "cpu",
                           run.Phases())
        got.append(res["attempted"])
        err = capsys.readouterr().err
        assert f"{len(due)} requests due over 3.0 s" in err
        assert "drain cap 60 s" in err and "generator lateness max" in err
    assert got == [len(due), len(due)]


def test_what_a_request_carries_follows_the_seed():
    assert traffic.request_seed(1, 0) != traffic.request_seed(2, 0)
    assert traffic.prompt(1, 0, 16, 1000) != traffic.prompt(2, 0, 16, 1000)
    assert traffic.request_seed(1, 3) == traffic.request_seed(1, 3)


def test_on_off_bursts_keep_the_mean_rate_and_the_off_periods_empty():
    mix = dict(MIX, arrival="onoff", on_s=10.0, off_s=20.0, rate_per_min=30.0)
    a = traffic.arrivals(mix, 3000.0)
    assert a == traffic.arrivals(dict(mix), 3000.0) and a == sorted(a)
    assert all(t % 30.0 < 10.0 for t in a)
    assert abs(len(a) / 3000.0 * 60.0 - 30.0) < 3.0


def test_an_unknown_arrival_process_is_refused():
    import pytest

    with pytest.raises(ValueError, match="arrival"):
        traffic.arrivals(dict(MIX, arrival="bursty"), 10.0)
