"""The port's spans laid on a device trace.

The port records spans (``candle_video_tpu_torch/utils/debug.py``): a name,
an id, the parent open on its thread, the thread (``threading.get_ident()``),
its start and end in ``time.perf_counter_ns()`` and a few attributes.  A
``torch.profiler`` run of the card's activity alone (``trace.Window``)
holds, besides each kernel, the CUDA API call that launched it, joined to
the kernel by the correlation id CUPTI gives both (the ctypes-launched
kernels included); the call's ``device_resource_id`` is the low 32 bits of
the launching thread's ``threading.get_ident()``.  So each kernel goes to
the innermost span open on its launching thread at its launch, and each
idle gap to the span open on the thread that launches the kernel ending it,
when the gap began; ``offset_ns`` (trace ns less ``perf_counter`` ns) is
``Trace.offset_ns``.  A span here is anything with the fields of the port's
``debug.SpanRecord``: this module does not import the port.
"""

from __future__ import annotations

import re
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple


class Kernel(NamedTuple):
    """One device activity of a profiler run (kernel, copy or set), in the
    trace's clock: its start and duration, and the host start and thread
    (a 32-bit ``threading.get_ident()``) of the CUDA API call that launched
    it, None where the trace has no such call."""

    name: str
    start_ns: int
    dur_ns: int
    launch_ns: Optional[int]
    tid: Optional[int]


_LAUNCH_CALL = re.compile(r"Launch|Memcpy|Memset")


def launched_kernels(prof) -> List[Kernel]:
    """The device activity of a finished ``torch.profiler`` run, each joined
    to its launch through the correlation id, in start order."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    events = prof.profiler.kineto_results.events()
    launches = {}
    for ev in events:
        if ev.device_type() != cuda and _LAUNCH_CALL.search(ev.name()):
            launches[ev.correlation_id()] = (int(ev.start_ns()), ev.device_resource_id())
    out = []
    for ev in events:
        if ev.device_type() == cuda and not ev.is_user_annotation():
            at, tid = launches.get(ev.correlation_id(), (None, None))
            out.append(Kernel(ev.name(), int(ev.start_ns()), int(ev.duration_ns()), at, tid))
    return sorted(out, key=lambda k: k.start_ns)


def _tid32(tid: int) -> int:
    tid &= 0xFFFFFFFF
    return tid - (1 << 32) if tid >= 1 << 31 else tid


def innermost(spans: Sequence, queries: Sequence) -> List[Optional[int]]:
    """For each query (tid, t in ``perf_counter_ns``), or None, the id of the
    innermost span open on that thread at t: of the spans that hold t, the
    one that began last (a thread's spans nest).  Threads compare as 32-bit
    ids; spans without a thread hold nothing."""
    by_tid: Dict[int, list] = {}
    for s in spans:
        if s.tid is not None:
            by_tid.setdefault(_tid32(s.tid), []).append(s)
    out: List[Optional[int]] = [None] * len(queries)
    asked: Dict[int, list] = {}
    for i, q in enumerate(queries):
        if q is not None and q[0] is not None:
            asked.setdefault(_tid32(q[0]), []).append((q[1], i))
    for tid, qs in asked.items():
        ss = sorted(by_tid.get(tid, ()), key=lambda s: (s.start_ns, -s.end_ns))
        stack, j = [], 0
        for t, i in sorted(qs):
            while j < len(ss) and ss[j].start_ns <= t:
                while stack and stack[-1].end_ns <= ss[j].start_ns:
                    stack.pop()
                stack.append(ss[j])
                j += 1
            while stack and stack[-1].end_ns <= t:
                stack.pop()
            out[i] = stack[-1].id if stack else None
    return out


def attribute(kernels: Sequence[Kernel], spans: Sequence, offset_ns: int) -> List[Optional[int]]:
    """The innermost span open on each kernel's launching thread at its
    launch; None where no span was open or the launch is not in the trace."""
    return innermost(spans, [None if k.launch_ns is None else (k.tid, k.launch_ns - offset_ns)
                             for k in kernels])


def idle_gaps(kernels: Sequence[Kernel], spans: Sequence, offset_ns: int,
              start_ns: int, end_ns: int) -> List[Tuple[int, int, Optional[int]]]:
    """The device's idle gaps between ``start_ns`` and ``end_ns`` (trace
    ns), the gaps ``Trace.idle_gaps`` sums: (start, nanoseconds, span id),
    the span being the innermost one open, on the thread that launched the
    kernel that ends the gap, when the gap began (None after the last
    kernel)."""
    gaps, nxt, prev = [], [], start_ns
    for k in sorted(kernels, key=lambda k: k.start_ns):
        a, b = max(k.start_ns, start_ns), min(k.start_ns + k.dur_ns, end_ns)
        if b <= a:
            continue
        if a > prev:
            gaps.append((prev, a - prev))
            nxt.append(k)
        prev = max(prev, b)
    owners = innermost(spans, [None if k.launch_ns is None else (k.tid, g[0] - offset_ns)
                               for g, k in zip(gaps, nxt)])
    if end_ns > prev:
        gaps.append((prev, end_ns - prev))
        owners.append(None)
    return [(a, n, o) for (a, n), o in zip(gaps, owners)]


def refined_idle(kernels: Sequence[Kernel], spans: Sequence, offset_ns: int, start_ns: int,
                 end_ns: int, label) -> List[list]:
    """Idle seconds by ``label(gap start)``, as ``Trace.idle_gaps`` sums
    them, each ``inside_*`` label refined to ``<label>:<span>`` by the span
    ``idle_gaps`` gives the gap (``:none`` where none is open); largest
    first, none left out.  A label's refinements sum to its total."""
    names = {s.id: s.name for s in spans}
    by: Dict[str, int] = {}
    for a, n, sid in idle_gaps(kernels, spans, offset_ns, start_ns, end_ns):
        key = label(a)
        if key.startswith("inside_"):
            key += ":" + names.get(sid, "none")
        by[key] = by.get(key, 0) + n
    return [[k, v / 1e9] for k, v in sorted(by.items(), key=lambda x: -x[1])]


# the leaf spans and the part of a step or a decode each one is
LEAVES = {"matmul": "matmul", "w4.dequant": "dequant", "w8.dequant": "dequant",
          "attn.kernel": "attention", "attn.cross": "cross_attention", "conv": "conv"}


def _by_root(kernels, owners, spans, root, part, weight):
    """Sum ``weight(kernel)`` by (root span id, ``part(path)``), the path
    being the spans from the kernel's owner up to, not into, the nearest
    ``root`` span; kernels with no such root are left out."""
    by_id = {s.id: s for s in spans}
    memo: Dict[int, Optional[tuple]] = {}

    def find(sid):
        if sid not in memo:
            path, s = [], by_id.get(sid)
            while s is not None and s.name != root:
                path.append(s)
                s = by_id.get(s.parent)
            memo[sid] = None if s is None else (s.id, part(path))
        return memo[sid]

    out: Dict[int, Dict[str, int]] = {}
    for k, sid in zip(kernels, owners):
        hit = None if sid is None else find(sid)
        if hit is not None:
            parts = out.setdefault(hit[0], {})
            parts[hit[1]] = parts.get(hit[1], 0) + weight(k)
    return out


def split(kernels: Sequence[Kernel], owners: Sequence[Optional[int]], spans: Sequence,
          root: str, weight=lambda k: k.dur_ns) -> Dict[int, Dict[str, int]]:
    """Device nanoseconds (or another ``weight`` of a kernel) of the kernels
    launched inside each ``root`` span (by id), by part: the innermost leaf
    span above the launch (``LEAVES``), else ``glue:<the innermost span>``."""
    def part(path):
        leaf = next((LEAVES[s.name] for s in path if s.name in LEAVES), None)
        return leaf or "glue:" + (path[0].name if path else root)

    return _by_root(kernels, owners, spans, root, part, weight)


def by_child(kernels: Sequence[Kernel], owners: Sequence[Optional[int]], spans: Sequence,
             root: str) -> Dict[int, Dict[str, int]]:
    """Device nanoseconds of the kernels launched inside each ``root`` span,
    by the root's child that holds the launch (the root's own name for a
    launch outside every child)."""
    return _by_root(kernels, owners, spans, root,
                    lambda path: path[-1].name if path else root, lambda k: k.dur_ns)


def summarize(kernels: Sequence[Kernel], spans: Sequence, offset_ns: int, start_ns: int,
              end_ns: int) -> dict:
    """The attribution of a profiled window (trace ns ``start_ns`` to
    ``end_ns``): per step, per decode and per T5 encode the mean device ms
    by part, glue by module span; the kernel seconds no span claims; idle
    ms by the span open when each gap began."""
    ks = [k for k in kernels if start_ns <= k.start_ns < end_ns]
    owners = attribute(ks, spans, offset_ns)
    names = {s.id: s.name for s in spans}
    total = sum(k.dur_ns for k in ks) or 1
    unclaimed: dict = {}
    for k, o in zip(ks, owners):
        if o is None:
            unclaimed[k.name[:70]] = unclaimed.get(k.name[:70], 0) + k.dur_ns
    out = dict(kernel_s=total / 1e9, kernels=len(ks),
               unclaimed_share=sum(unclaimed.values()) / total,
               unclaimed_top=sorted(((n, v / 1e6) for n, v in unclaimed.items()),
                                    key=lambda x: -x[1])[:5])
    for root in ("denoise_step", "vae_decode", "t5_encode"):
        per = split(ks, owners, spans, root)
        mean: dict = {}
        for parts in per.values():
            for part, ns in parts.items():
                mean[part] = mean.get(part, 0.0) + ns / 1e6 / len(per)
        glue = sum(v for p, v in mean.items() if p.startswith("glue:"))
        launches = split(ks, owners, spans, root, lambda k: 1)
        out[root] = dict(count=len(per), ms=sum(mean.values()), glue_ms=glue,
                         launches=sum(sum(p.values()) for p in launches.values())
                         / max(1, len(per)),
                         parts_ms=dict(sorted(mean.items(), key=lambda x: -x[1])))
    gaps: dict = {}
    for _, ns, sid in idle_gaps(ks, spans, offset_ns, start_ns, end_ns):
        key = names.get(sid, "none")
        gaps[key] = gaps.get(key, 0.0) + ns / 1e6
    out["idle_ms_by_span"] = dict(sorted(gaps.items(), key=lambda x: -x[1]))
    claimed = {o for o in owners if o is not None}
    leaves = [s for s in spans if s.name in LEAVES
              and start_ns <= s.start_ns + offset_ns < end_ns]
    out["leaf_spans_without_kernel"] = {
        n: [sum(1 for s in leaves if s.name == n and s.id not in claimed),
            sum(1 for s in leaves if s.name == n)]
        for n in sorted({s.name for s in leaves})}
    return out
