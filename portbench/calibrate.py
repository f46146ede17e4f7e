"""Readings that set a cell's limits and its serving rate; run on the card,
never by the benchmark's own runs.

    python3 -m portbench.calibrate readings --workload <cell> --seeds 1 2 ... \\
        --control-seeds 1 2 3 --seconds 4
    python3 -m portbench.calibrate sweep --workload <cell> --rates 50 60 70 --seconds 40

``readings``: for each seed, one run of the cell as ``run.py`` makes it
(``run.measure``, with a window of the given seconds) and its check
(``run.check``): the program's readings.  On the control seeds the same
requests again with the family's reference at its control precision in the
program's place (``run.check(control=<the family's CONTROL>)``, under that
name; LTX-Video's ``fp8`` is float8 in every DiT block linear and VAE conv,
so that its latents, taken before the decode, have the DiT's linears alone
in float8).  One JSON line a seed.  ``sweep``: the open mix at each offered rate for the
given seconds on one warm pipeline: completed videos a minute, the p95
sojourn, and the mean sojourn of the first and the last third of the
requests (a growing backlog shows as the last third waiting longer).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from portbench import run


def readings(args, cell, config, mix):
    for seed in args.seeds:
        t0 = time.perf_counter()
        ctx = run.measure(cell, config, mix, seed, args.seconds, False, "cuda", run.Phases())
        t1 = time.perf_counter()
        line = {"seed": seed, "requests": len(ctx.requests), "program": run.check(ctx, mix),
                "measure_s": t1 - t0, "check_s": time.perf_counter() - t1}
        if seed in args.control_seeds:
            control = run.family(config).CONTROL
            line[control] = run.check(ctx, mix, control=control)
        del ctx
        torch.cuda.empty_cache()
        print(json.dumps(line), flush=True)


def sweep(args, cell, config, mix):
    from portbench.arith import percentile

    fam = run.family(config, mix["mode"])
    ctx = run.Context(cell=cell, config=config, mix=mix, seed=args.seeds[0],
                      phases=run.Phases(), traced=False, device=torch.device("cuda"))
    pipe = fam.build(config, fam.make_weights(config, ctx.seed, "cuda"), "cuda",
                     lambda phase: None)
    for rate in args.rates:
        m = dict(mix, rate_per_min=rate)
        run.open_loop(ctx, pipe, m, args.seconds, False)
        lat = ctx.latency
        third = max(1, len(lat) // 3)
        span = ctx.window[1] - ctx.window[0]
        print(json.dumps({"rate_per_min": rate, "requests": ctx.attempted,
                          "failed": ctx.failed,
                          "videos_per_min": len(ctx.requests) / span * 60.0,
                          "p95_s": percentile(lat, 95), "p50_s": percentile(lat, 50),
                          "first_third_mean_s": sum(lat[:third]) / third,
                          "last_third_mean_s": sum(lat[-third:]) / third}), flush=True)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("what", choices=("readings", "sweep"))
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--rates", type=float, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=40.0)
    args = p.parse_args(argv)
    run.set_cache_env()
    _, cell, config, mix, _, _, _ = run.load_cell(args.workload)
    if not torch.cuda.is_available():
        run.fail("calibration needs the card")
    {"readings": readings, "sweep": sweep}[args.what](args, cell, config, mix)
    print(f"portbench: card {run.power_limit()}", file=sys.stderr)


if __name__ == "__main__":
    main()
