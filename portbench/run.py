"""Run one cell of the benchmark once and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell (``BENCHMARK.json``'s ``workloads``) names a configuration
(``portbench/configs/<config>.json``) and a traffic mix
(``portbench/traffic/<mix>.json``); its limits for ``correct`` are in
``portbench/limits/<cell>.json`` and each per-layer metric's reader in
``portbench/metrics/<metric>.py``.  The configuration names its model family
(``"family"``, by default ``ltx_video``), whose module
``portbench/families/<family>.py`` makes the weights, builds the program,
sends one request and gives the plain reference; this file knows no model.
A run makes the weights from the seed on the card, hands them to the
program, warms the cell's shapes, measures for the given seconds (traced
with ``--trace 1``), then frees the program and checks a sample of the
requests it served against the family's reference: their final latents,
before the decode, and their videos.  Set-up by phase and the numbers
compared, each beside its limit, go to standard error; the last line of
standard output is the result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import queue  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "candle_video_tpu", "benches", "bench", "scripts")
WARM_INDEX = 10 ** 6  # the request index of the warm-up, past any window's
FAMILIES = HERE / "families"
DEFAULT_FAMILY = "ltx_video"  # a configuration file without "family"


def fail(msg: str, code: int = 2):
    print(f"portbench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def set_cache_env():
    """Every build and kernel cache in fixed directories of the checkout, so
    that only the first run of a checkout builds; no library loads JAX.
    That takes in the compiled bytecode of every module imported from here
    on (the port, torch and their dependencies, whose own directories may
    be read-only)."""
    cache = ROOT / ".portbench_cache"
    sys.pycache_prefix = str(cache / "pyc")
    sys.dont_write_bytecode = False
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(cache / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def load_cell(name: str):
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        fail(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    config = json.loads((HERE / "configs" / f"{cell['config']}.json").read_text())
    mix = json.loads((HERE / "traffic" / f"{cell['traffic']}.json").read_text())
    limits = json.loads((HERE / "limits" / f"{name}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    layer = [m for m in bench["per_layer"] if name in m.get("workloads", [name])]
    return bench, cell, config, mix, limits, e2e, layer


def family(config: dict, mode: str | None = None):
    """The family module ``<FAMILIES>/<family>.py`` that ``config`` names,
    loaded by path once; with ``mode``, a traffic mode it has to serve."""
    name = config.get("family", DEFAULT_FAMILY)
    path = FAMILIES / f"{name}.py"
    key = f"portbench.families.{name}"
    mod = sys.modules.get(key)
    if mod is None or Path(mod.__file__).resolve() != path.resolve():
        if not (isinstance(name, str) and name.isidentifier() and path.is_file()):
            fail(f"no family module {str(path)!r} for the family {name!r} of configuration "
                 f"{config.get('name')!r}")
        spec = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        try:
            spec.loader.exec_module(mod)
        except BaseException:
            del sys.modules[key]
            raise
    if mode is not None and mode not in mod.MODES:
        fail(f"the family {name!r} serves the modes {list(mod.MODES)}, not the mix's {mode!r}")
    return mod


class Phases:
    """Set-up seconds by phase, from process start."""

    def __init__(self):
        self.t = T_START
        self.phases = {}

    def done(self, name: str):
        now = time.perf_counter()
        self.phases[name] = self.phases.get(name, 0.0) + now - self.t
        self.t = now


def to_host_u8(video):
    """[1, 3, F, H, W] f32 in [0, 255] on the card -> uint8 [3, F, H, W] in
    host memory."""
    import torch

    return torch.round(video[0]).to(torch.uint8).cpu()


class HostVideos:
    """The client's side of a request's end: its video as uint8 in one
    reused page-locked host buffer (a plain DMA, no page faults); the
    videos of the requests picked for the check are kept as copies."""

    def __init__(self, mix, device, keep):
        import torch

        shape = (3, mix["num_frames"], mix["height"], mix["width"])
        self.buf = torch.empty(shape, dtype=torch.uint8,
                               pin_memory=torch.device(device).type == "cuda")
        self.keep, self.kept = set(keep), {}

    def take(self, i, video):
        import torch

        self.buf.copy_(torch.round(video[0]).to(torch.uint8))
        if i in self.keep:
            self.kept[i] = self.buf.clone()


class LatentTap:
    """The ``step_callback`` of every timed ``generate`` call: after a
    call's last step it keeps, on the device, the final latents of the
    rows whose request is in ``keep``.  ``first`` is the request index of
    the call's first row: the closed loop sets it before each call; served
    calls take their rows in the order the requests were submitted (all of
    the open mix's requests batch with each other), so it counts on from
    the rows served.  ``rows`` holds the rows of the call that served each
    kept request."""

    def __init__(self, keep=()):
        self.keep, self.first, self.armed = set(keep), 0, False
        self.kept, self.rows = {}, {}

    def __call__(self, i, n, lat):
        if not self.armed or i != n - 1:
            return
        for j in range(lat.shape[0]):
            if self.first + j in self.keep:
                self.kept[self.first + j] = lat[j].clone()
                self.rows[self.first + j] = lat.shape[0]
        self.first += lat.shape[0]


def sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def reset_peak(device):
    import torch

    gc.collect()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def read_peak(device) -> int:
    import torch

    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0


# ---------------------------------------------------------------------------
# the windows
# ---------------------------------------------------------------------------


def _labeller(spans, inside: str, outside: str):
    """label(t) of a trace time: ``inside`` when one of the sorted, disjoint
    (start, end) spans holds it, else ``outside``."""
    import bisect

    ends = [e for _, e in spans]

    def label(t):
        i = bisect.bisect_right(ends, t)
        return inside if i < len(spans) and spans[i][0] <= t else outside

    return label


def closed_loop(ctx, pipe, mix, seconds, traced):
    """One client: each request waits for the last one's video.  In a traced
    run the first half of the window passes ``stage_times`` (the stage
    metrics) and the profiler records the second half (the device metrics)."""
    from portbench import trace as T
    from portbench import traffic

    fam = family(ctx.config)

    def request(i, stage_times=None):
        tap.first = i
        host.take(i, fam.request(pipe, ctx.config, mix, ctx.seed, i, stage_times, tap))

    # warm-up: the cell's one shape, a prompt no window request has; the
    # check's sample is drawn from the seconds / its time requests that a
    # window finishes as a rule; one the window did not reach is served
    # after its close through the same call, and counts in no metric
    host, tap = HostVideos(mix, ctx.device, ()), LatentTap()
    w = time.perf_counter()
    request(WARM_INDEX)
    sure = max(1, int(seconds / (time.perf_counter() - w)))
    host.keep = tap.keep = set(traffic.sample(ctx.seed, sure, mix["check_requests"]))
    tap.armed = True
    win = T.Window(traced)
    sync(ctx.device)
    ctx.phases.done("warmup")
    reset_peak(ctx.device)
    done = []
    with win:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            if traced and time.perf_counter() - t0 >= seconds / 2:
                win.start()
            st = {} if traced and win.started_at is None else None
            a = time.perf_counter()
            request(len(done), st)
            done.append(dict(index=len(done), start=a, end=time.perf_counter(), stages=st))
    ctx.peak = read_peak(ctx.device)
    for i in sorted(host.keep):
        if i >= len(done):
            request(i)
    ctx.sample = [dict(index=i, video=host.kept[i], latents=tap.kept[i])
                  for i in sorted(host.keep)]
    ctx.window = (t0, done[-1]["end"])
    ctx.latency = [r["end"] - r["start"] for r in done]
    ctx.requests = done
    ctx.attempted, ctx.failed = len(done), 0
    if win.trace is not None:
        tr = ctx.trace = win.trace
        tr.end = tr.at(ctx.window[1])
        traced_reqs = [r for r in done if r["start"] >= win.started_at]
        ctx.traced_requests = len(traced_reqs)
        ctx.idle_label = _labeller([(tr.at(r["start"]), tr.at(r["end"])) for r in traced_reqs],
                                   "inside_requests", "between_requests")


class _LogTap:
    """Standard error, with the serving layer's JSON log lines kept."""

    def __init__(self, inner):
        self.inner, self.lines = inner, []

    def write(self, s):
        if s.startswith('{"ts"'):
            self.lines.append(s)
        return self.inner.write(s)

    def flush(self):
        self.inner.flush()

    def __getattr__(self, name):
        return getattr(self.inner, name)


def open_loop(ctx, pipe, mix, seconds, traced):
    """Requests fall due on the mix's fixed schedule; the family's server
    batches them.  Each sojourn runs from the request's due time to its
    video in host memory."""
    import numpy as np

    from portbench import trace as T
    from portbench import traffic

    dev = ctx.device
    due = traffic.arrivals(mix, seconds)
    n = len(due)
    # the check's sample: the videos of the first check_requests drawn, the
    # final latents of the first latent_candidates drawn (the batched rows
    # among them are checked too)
    drawn = traffic.sample(ctx.seed, n, mix["latent_candidates"])
    tap = LatentTap(drawn)
    server = family(ctx.config).Served(pipe, ctx.config, mix, ctx.seed, n, dev, tap, WARM_INDEX)
    server.warmup()
    tap.armed = True
    host = HostVideos(mix, dev, drawn[:mix["check_requests"]])
    win = T.Window(traced)
    sync(dev)
    ctx.phases.done("warmup")
    reset_peak(dev)
    server.start()
    outs, submitted, finished = [], [None] * n, [None] * n
    log_tap = None
    if traced:
        os.environ["CVT_LOG"] = "info"
        log_tap = sys.stderr = _LogTap(sys.stderr)
    t_deadline = [None]

    def collect():
        for i in range(n):
            while len(outs) <= i:
                time.sleep(0.001)
            timeout = max(0.0, t_deadline[0] - time.perf_counter()) if t_deadline[0] else None
            try:
                res = outs[i].get(timeout=timeout)
            except queue.Empty:
                return
            if isinstance(res, Exception):
                print(f"portbench: request {i} raised {res!r}", file=sys.stderr)
                continue
            host.take(i, res)
            finished[i] = time.perf_counter()

    with win:
        t0 = time.perf_counter() + 0.05
        t_deadline[0] = t0 + seconds + mix["drain_cap_s"]
        collector = threading.Thread(target=collect, daemon=True)
        collector.start()
        for i, d in enumerate(due):
            wait = t0 + d - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            if traced and d >= seconds / 2:
                win.start()
            submitted[i] = time.perf_counter()
            outs.append(server.submit(i))
        collector.join(timeout=max(0.0, t_deadline[0] - time.perf_counter()) + 5.0)
    if traced:
        sys.stderr = log_tap.inner
        os.environ.pop("CVT_LOG", None)
    server.stop()
    ctx.peak = read_peak(dev)
    ok = [i for i in range(n) if finished[i] is not None]
    ctx.attempted, ctx.failed = n, n - len(ok)
    last = max(finished[i] for i in ok)
    ctx.window = (t0 + due[0], last)
    # a request that never came back counts with the whole drain cap
    ctx.latency = [(finished[i] if finished[i] is not None else t_deadline[0]) - (t0 + due[i])
                   for i in range(n)]
    late = [submitted[i] - (t0 + due[i]) for i in range(n)]
    print(f"portbench: open loop: {n} requests due over {seconds} s at "
          f"{mix['rate_per_min']}/min (schedule seed {mix['schedule_seed']}); drain cap "
          f"{mix['drain_cap_s']} s after the close; generator lateness max "
          f"{max(late) * 1e3:.3f} ms, mean {np.mean(late) * 1e3:.3f} ms; {ctx.failed} missed "
          "the cap", file=sys.stderr)
    print("portbench: sojourns (s, in due order): " + json.dumps(
        [round(x, 4) for x in ctx.latency]), file=sys.stderr)
    # the requests checked: those with a kept video, and up to check_batched
    # more that rode a batch, in the order drawn
    batched = [i for i in drawn[mix["check_requests"]:] if tap.rows.get(i, 1) > 1]
    checked = set(host.kept) | set(batched[:mix["check_batched"]])
    ctx.requests = [dict(index=i) for i in ok]
    ctx.sample = [dict(index=i, video=host.kept.get(i), latents=tap.kept.get(i),
                       rows=tap.rows.get(i), **server.carried(i))
                  for i in ok if i in checked]
    if traced:
        # the served calls, from the serving layer's log line: (start, end,
        # rows) in perf_counter seconds
        calls = []
        now_wall, now_perf = time.time(), time.perf_counter()
        for line in log_tap.lines:
            rec = json.loads(line)
            if rec.get("stage") == "serve":
                end = rec["ts"] - now_wall + now_perf
                calls.append((end - rec["ms"] / 1e3, end, rec["rows"]))
        calls = [c for c in calls if c[1] >= ctx.window[0]]
        ctx.serve_calls = [c for c in calls if win.started_at is None or c[1] <= win.started_at]
        ctx.traced_calls = [c for c in calls if win.started_at is not None
                            and c[0] >= win.started_at]
    if win.trace is not None:
        tr = ctx.trace = win.trace
        tr.end = tr.at(ctx.window[1])
        ctx.idle_label = _labeller([(tr.at(a), tr.at(b)) for a, b, _ in ctx.traced_calls],
                                   "inside_served_generate_calls",
                                   "between_served_generate_calls")


# ---------------------------------------------------------------------------
# the check
# ---------------------------------------------------------------------------


def check(ctx, mix, control=None):
    """The sampled requests against the family's reference, with the
    program freed: each one's final latents and, where its video was kept,
    its video.  With ``control`` (the family's ``CONTROL``), the reference
    at that precision stands in the program's place: the control's
    readings."""
    fam = family(ctx.config)
    config, seed, dev = ctx.config, ctx.seed, ctx.device
    raw = fam.reference_weights(config, seed, dev, mix)
    worst = {}
    for r in ctx.sample:
        ref_lat, noise = fam.reference_latents(raw, config, mix, seed, r, dev)
        if control is None:
            lat, video = r.get("latents"), r.get("video")
        else:
            lat = fam.reference_latents(raw, config, mix, seed, r, dev, control)[0]
            video = to_host_u8(fam.reference_video(raw, config, mix, seed, r, lat, dev,
                                                   control)[None])
        errors = {"latent_rel_rms": latent_error(lat, ref_lat, noise)}
        if video is not None:
            errors.update(video_errors(video, fam.reference_video(raw, config, mix, seed, r,
                                                                  ref_lat, dev)))
        for name, v in errors.items():
            worst[name] = max(worst.get(name, 0.0), v)
    worst["requests_checked"] = len(ctx.sample)
    worst["batched_rows_checked"] = sum(1 for r in ctx.sample if (r.get("rows") or 1) > 1)
    return worst


def latent_error(lat, ref_lat, noise) -> float:
    """RMS of (program - reference) over one request's final packed
    latents, over the standard deviation of the reference's way from its
    initial noise to them: the gap against what the denoise steps did (the
    noise, which both sides share, would hide it).  A request whose latents
    were not kept reads infinite."""
    if lat is None:
        return float("inf")
    ref = ref_lat.reshape(-1)
    diff = lat.to(ref.device).float().reshape(-1) - ref
    return float(diff.square().mean().sqrt() / (ref - noise.reshape(-1)).std())


def video_errors(video_u8, ref):
    """``rel_rms``: RMS of (program - reference) over the reference's
    standard deviation, whole video; ``frame_rel_rms``: the same for the
    worst frame."""
    diff = video_u8.to(ref.device).float() - ref
    std = ref.std()
    frame = diff.square().mean(dim=(0, 2, 3)).sqrt().max()
    return {"rel_rms": float(diff.square().mean().sqrt() / std),
            "frame_rel_rms": float(frame / std)}


# ---------------------------------------------------------------------------


class Context:
    """What a run gives the metric readers: the cell, its configuration and
    mix, the finished requests (with ``stages`` in a traced run), the window,
    the trace, the served calls."""

    def __init__(self, **kw):
        self.trace = None
        self.sample = []  # the requests the check compares
        self.serve_calls = []  # served calls of the untraced half
        self.traced_calls = []  # served calls of the traced half
        self.traced_requests = 0  # closed-loop requests of the traced half
        self.idle_label = None
        self.__dict__.update(kw)


def metric_reader(name: str):
    """The module ``portbench/metrics/<name>.py`` (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(f"portbench.metrics.{name}",
                                                  HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def power_limit():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return "unknown"


def measure(cell, config, mix, seed, seconds, traced, device, phases):
    """Build, warm and measure one run of a cell on ``device``; the program
    is freed before this returns.  Returns the run's ``Context``."""
    import torch

    fam = family(config, mix["mode"])
    device = torch.device(device)
    ctx = Context(cell=cell, config=config, mix=mix, seed=seed, phases=phases,
                  traced=traced, device=device)
    raw = fam.make_weights(config, seed, device)
    sync(device)
    phases.done("weights")
    pipe = fam.build(config, raw, device, lambda name: (sync(device), phases.done(name)))
    del raw
    window = {"closed": closed_loop, "open": open_loop}[mix["mode"]]
    window(ctx, pipe, mix, seconds, traced)
    ctx.setup_s = sum(phases.phases.values())
    del pipe
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return ctx


def result_of(ctx, limits, e2e, layer):
    """The metrics of a measured run and its check: the result line's
    object, with the numbers compared under ``checks``."""
    import torch

    from portbench.arith import percentile

    print("portbench: set-up by phase (s): " + json.dumps(
        {k: round(v, 3) for k, v in ctx.phases.phases.items()}), file=sys.stderr)
    metrics = {}
    if ctx.traced:
        for m in layer:
            v = metric_reader(m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        span = ctx.window[1] - ctx.window[0]
        values = {"videos_per_min": len(ctx.requests) / span * 60.0,
                  "request_p95_s": percentile(ctx.latency, 95),
                  "peak_mem_gib": ctx.peak / 2 ** 30, "setup_s": ctx.setup_s}
        for m in e2e:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    got = check(ctx, ctx.mix)
    print(f"portbench: checked {got['requests_checked']} requests, "
          f"{got['batched_rows_checked']} of them rows of a batch; indices "
          f"{[r['index'] for r in ctx.sample]}", file=sys.stderr)
    for k in ("latent_rel_rms", "rel_rms", "frame_rel_rms"):
        if k not in limits["compared"]:
            print(f"portbench: reading {k} = {got[k]!r} (not compared)", file=sys.stderr)
    checks = {k: {"value": got[k], "limit": limits[k]} for k in limits["compared"]}
    correct = ctx.failed == 0 and all(c["value"] <= c["limit"] for c in checks.values())
    dev = ctx.device
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    result = {"correct": correct, "attempted": ctx.attempted, "failed": ctx.failed,
              "metrics": metrics,
              "device": {"platform": "gpu" if dev.type == "cuda" else "cpu", "kind": kind,
                         "count": 1, "memory_peak_bytes": int(ctx.peak)}}
    if ctx.trace is not None:
        tr = ctx.trace
        result["device"].update(busy_s=tr.busy_s, window_s=tr.window_s)
        result["breakdown"] = {"device_ops": tr.top_ops(10),
                               "idle_gaps": tr.idle_gaps(ctx.idle_label)}
    result["checks"] = checks
    return result


def run_cell(cell, config, mix, limits, e2e, layer, seed, seconds, traced, device, phases):
    """One run of a cell on ``device``: build, warm, measure, check.
    Returns the result line's object."""
    ctx = measure(cell, config, mix, seed, seconds, traced, device, phases)
    return result_of(ctx, limits, e2e, layer)


def forbidden_loaded():
    """The whole top-level names of loaded modules that must not load."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    set_cache_env()
    bench, cell, config, mix, limits, e2e, layer = load_cell(args.workload)
    phases = Phases()
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        fail(f"the cell needs {cell['chips']} CUDA device(s); "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found")
    family(config, mix["mode"])  # the port's import, timed as its own phase

    phases.done("imports")
    torch.ones(1, device="cuda")
    phases.done("cuda_init")
    result = run_cell(cell, config, mix, limits, e2e, layer, args.seed % (1 << 63), args.seconds,
                      bool(args.trace), "cuda", phases)
    print(f"portbench: card {power_limit()}", file=sys.stderr)
    for k, c in result["checks"].items():
        print(f"portbench: check {k} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    found = forbidden_loaded()
    if found:
        fail(f"modules that must not load were loaded: {found}", 3)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
