"""Where a cell's time goes by the port's spans, in one traced run.

Runs the cell as ``python3 -m portbench.run --trace 1`` measures it
(``run.measure``: the untraced first half, the profiled second half), with
the port's span recorder on for the whole run and the profiler's launch
calls kept (``spans.launched_kernels``), and prints:

- per denoise step of the traced half the device ms of matmul, W4 dequant,
  attention kernel, cross-attention and glue by module span, per decode
  conv and glue, per T5 encode its parts (``spans.summarize``), and the
  share of the kernel time no span claims;
- the run's ``breakdown.idle_gaps`` with each ``inside_*`` label refined by
  span (``spans.refined_idle``);
- the host ms of issuing a step: the first half's ``denoise_step`` spans,
  each opened on an idle card, since ``stage_times`` syncs around each step;
- in a served cell, the mean ``serve.queue_wait`` of the requests whose
  call ended in the first half (the calls ``service_s.serve`` reads), and
  each part of a served call (``serve.rows``, ``generate``,
  ``serve.handoff``): its host ms in the first half, its device ms in the
  traced half;
- those readings under the names of the per-layer metrics they would give
  (``glue_ms.step``, ``w4_dequant_ms.step``, ``decode_glue_ms``,
  ``step_launch_ms``, ``queue_wait_s.serve``); none is in ``BENCHMARK.json``.

``--cost N`` instead measures N pairs of untraced runs, recording off and
on in turns (off, on, on, off, ...): the host cost of recording with the
profiler off.  Needs one CUDA device:

    python3 -m portbench.span_split --workload <cell> --seed <n> --seconds <s>
        [--cost N] [--json FILE]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import time

from portbench import run as R
from portbench import spans as S
from portbench import trace as T


class _LaunchWindow(T.Window):
    """``trace.Window``, keeping its run's kernels with their launches."""

    kernels = None

    def stop(self):
        prof = self._prof
        super().stop()
        if prof is not None:
            _LaunchWindow.kernels = S.launched_kernels(prof)


def _mean(xs):
    return statistics.fmean(xs) if xs else None


def _served(spans, ks, owners, first_ns, window_ns) -> dict:
    """Queue waits and the parts of a served call (see the module's doc)."""
    calls = sorted((s for s in spans if s.name == "serve.call"), key=lambda s: s.start_ns)
    starts = [c.start_ns for c in calls]
    waits = []
    for w in (s for s in spans if s.name == "serve.queue_wait"):
        # the call that takes a request starts once its wait has ended
        nxt = next((c for c, a in zip(calls, starts) if a >= w.end_ns), None)
        if nxt is not None and window_ns <= nxt.end_ns <= first_ns:
            waits.append((w.end_ns - w.start_ns) / 1e9)
    first = [c for c in calls if window_ns <= c.end_ns <= first_ns]
    ids = {c.id for c in first}
    host: dict = {}  # a part's mean over the calls that have it, and their count
    for s in spans:
        if s.parent in ids:
            host.setdefault(s.name, []).append((s.end_ns - s.start_ns) / 1e6)
    host = {k: [statistics.fmean(v), len(v)] for k, v in host.items()}
    per = S.by_child(ks, owners, spans, "serve.call")
    device: dict = {}  # device ms a traced call, by part
    for parts in per.values():
        for name, ns in parts.items():
            device[name] = device.get(name, 0.0) + ns / 1e6 / len(per)
    return dict(queue_wait_s=_mean(waits), requests=len(waits), calls=len(first),
                call_ms=_mean([(c.end_ns - c.start_ns) / 1e6 for c in first]),
                part_host_ms=host, traced_calls=len(per), part_device_ms=device)


def traced(cell, config, mix, seed, seconds, device="cuda") -> dict:
    from candle_video_tpu_torch.utils import debug

    window, T.Window = T.Window, _LaunchWindow
    try:
        with debug.recording():
            ctx = R.measure(cell, config, mix, seed, seconds, True, device, R.Phases())
    finally:
        T.Window = window
    spans, kernels, tr = debug.drain(), _LaunchWindow.kernels, ctx.trace
    out = S.summarize(kernels, spans, tr.offset_ns, tr.start, tr.end)
    ks = [k for k in kernels if tr.start <= k.start_ns < tr.end]
    out["launches_missing"] = sum(1 for k in ks if k.launch_ns is None)
    out["idle_gaps"] = tr.idle_gaps(ctx.idle_label)
    out["idle_gaps_refined"] = S.refined_idle(kernels, spans, tr.offset_ns, tr.start, tr.end,
                                              ctx.idle_label)
    first_ns, window_ns = tr.start - tr.offset_ns, int(ctx.window[0] * 1e9)
    steps = [(s.end_ns - s.start_ns) / 1e6 for s in spans if s.name == "denoise_step"
             and window_ns <= s.start_ns and s.end_ns <= first_ns]
    out["step_launch_ms"], out["untraced_steps"] = _mean(steps), len(steps)
    if mix["mode"] == "open":
        out["serve"] = _served(spans, ks, S.attribute(ks, spans, tr.offset_ns), first_ns,
                               window_ns)
    # the per-layer metrics these readings would give, for a benchmark to take up
    step, decode = out["denoise_step"], out["vae_decode"]
    out["metrics"] = {k: v for k, v in (
        ("glue_ms.step", step["glue_ms"] if step["count"] else None),
        ("w4_dequant_ms.step", step["parts_ms"].get("dequant")),
        ("decode_glue_ms", decode["glue_ms"] if decode["count"] else None),
        ("step_launch_ms", out["step_launch_ms"] if mix["mode"] == "closed" else None),
        ("queue_wait_s.serve", out.get("serve", {}).get("queue_wait_s"))) if v is not None}
    return out


def cost(cell, config, mix, seed, seconds, pairs, device="cuda") -> dict:
    from candle_video_tpu_torch.utils import debug

    runs = {"off": [], "on": []}
    for p in range(pairs):
        for mode in (("off", "on") if p % 2 == 0 else ("on", "off")):
            phases = R.Phases()
            phases.t = time.perf_counter()
            with debug.recording() if mode == "on" else contextlib.nullcontext():
                ctx = R.measure(cell, config, mix, seed, seconds, False, device, phases)
            debug.drain()
            span = ctx.window[1] - ctx.window[0]
            runs[mode].append(dict(videos_per_min=len(ctx.requests) / span * 60.0,
                                   mean_request_s=statistics.fmean(ctx.latency)))
    med = {m: statistics.median(r["mean_request_s"] for r in rs) for m, rs in runs.items()}
    return dict(runs=runs, median_request_s=med, on_over_off=med["on"] / med["off"])


def _print(name, res):
    print(f"span_split {name}: card {res['card']}")
    if "cost" in res:
        c = res["cost"]
        print(f"recording off / on, mean request s of each run: "
              f"{[round(r['mean_request_s'], 4) for r in c['runs']['off']]} / "
              f"{[round(r['mean_request_s'], 4) for r in c['runs']['on']]}; medians "
              f"{c['median_request_s']['off']:.4f} / {c['median_request_s']['on']:.4f} "
              f"({100 * (c['on_over_off'] - 1):+.2f}%)")
        return
    t = res["traced"]
    print(f"traced half: {t['kernels']} kernels, {t['kernel_s']:.4f} s; unclaimed "
          f"{100 * t['unclaimed_share']:.3f}% {t['unclaimed_top']}; launches missing "
          f"{t['launches_missing']}; leaf spans without a kernel "
          f"{t['leaf_spans_without_kernel']}")
    for root in ("denoise_step", "vae_decode", "t5_encode"):
        r = t[root]
        parts = ", ".join(f"{k} {v:.3f}" for k, v in r["parts_ms"].items())
        print(f"{root} x{r['count']}: {r['ms']:.3f} device ms each, {r['launches']:.0f} "
              f"launches, glue {r['glue_ms']:.3f}; {parts}")
    print(f"denoise_step host ms, untraced half (from an idle card): {t['step_launch_ms']} "
          f"over {t['untraced_steps']} steps")
    print("as metrics: " + json.dumps(t["metrics"]))
    print("idle_gaps (s): " + json.dumps(t["idle_gaps"]))
    print("idle_gaps refined (s): " + json.dumps(t["idle_gaps_refined"]))
    if "serve" in t:
        s = t["serve"]
        print(f"served: queue wait mean {s['queue_wait_s']} s over {s['requests']} requests "
              f"of {s['calls']} calls (call {s['call_ms']} ms); host ms of a part, calls "
              f"{json.dumps(s['part_host_ms'])}; device ms a call ({s['traced_calls']} "
              f"traced) {json.dumps(s['part_device_ms'])}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--cost", type=int, default=0, help="off/on pairs of untraced runs")
    p.add_argument("--json", help="also write the results to this file")
    args = p.parse_args(argv)
    R.set_cache_env()
    _, cell, config, mix, _, _, _ = R.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        R.fail("span_split needs a CUDA device")
    R.family(config, mix["mode"])

    torch.ones(1, device="cuda")
    seed = args.seed % (1 << 63)
    res = dict(workload=args.workload, seed=seed, card=R.power_limit())
    if args.cost:
        res["cost"] = cost(cell, config, mix, seed, args.seconds, args.cost)
    else:
        res["traced"] = traced(cell, config, mix, seed, args.seconds)
    _print(args.workload, res)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
