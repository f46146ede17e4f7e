"""Observability (``candle_video_tpu/utils/debug.py``): structured logging,
tensor dumps, profiling and spans, each off unless asked for.

- ``log``: one JSON line on stderr a record, gated by ``CVT_LOG``
  (``off`` | ``info`` | ``debug``);
- ``dump_tensor``: with ``CVT_DUMP_TENSORS=<dir>``, each call writes the
  tensor as f32 to ``<dir>/NNN_<name>[_stepS].safetensors`` under the key
  ``tensor``, through the port's own writer (``loader.save_safetensors``);
- ``trace``: with ``CVT_PROFILE=<dir>``, a ``torch.profiler`` window (CPU,
  and CUDA where there is a GPU) exported as a Chrome trace to
  ``<dir>/<name>.trace.json``; a no-op without it;
- ``span``: a named interval of the host's work (``generate``,
  ``denoise_step``, the ``matmul`` and ``attn.kernel`` leaves, the served
  call, ...).  Spans are kept only inside a ``recording()`` block and
  ``drain()`` hands them over.  Outside one, ``span`` is one flag test and a
  shared no-op context: it reads no clock, allocates no span and touches no
  CUDA API.  Inside, each span keeps its name, id, parent (the span open on
  its thread when it opened), thread, start and end in
  ``time.perf_counter_ns()`` and a few attributes; nothing is synced or
  written out.  A profiler's kernels go to the span open on their launching
  thread at their launch (``portbench/spans.py`` does that);
- ``StageTimer``: wall-clock seconds per named stage, read after the GPU's
  queued work has finished; each stage is also a span.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import sys
import threading
import time
from typing import Dict, List, NamedTuple, Optional

import torch

_LEVELS = {"off": 0, "info": 1, "debug": 2}


def _level() -> int:
    return _LEVELS.get(os.environ.get("CVT_LOG", "off").lower(), 0)


def log(stage: str, message: str = "", level: str = "info", **fields):
    if _LEVELS.get(level, 1) > _level():
        return
    rec = {"ts": round(time.time(), 3), "stage": stage, "msg": message}
    rec.update(fields)
    print(json.dumps(rec), file=sys.stderr, flush=True)


_DUMP_INDEX = itertools.count()


def dump_tensor(name: str, array, step: Optional[int] = None):
    """Save a tensor (or array) to ``$CVT_DUMP_TENSORS/<NNN>_<name>[_stepS].safetensors``."""
    out_dir = os.environ.get("CVT_DUMP_TENSORS")
    if not out_dir:
        return
    from ..models.ltx_video.loader import save_safetensors

    os.makedirs(out_dir, exist_ok=True)
    suffix = f"_step{step}" if step is not None else ""
    path = os.path.join(out_dir, f"{next(_DUMP_INDEX):03d}_{name}{suffix}.safetensors")
    tensor = torch.as_tensor(array).detach().to("cpu", torch.float32).contiguous()
    save_safetensors({"tensor": tensor}, path)
    log("dump", f"wrote {path}", level="debug")


@contextlib.contextmanager
def trace(name: str = "cvt"):
    """A ``torch.profiler`` window exported as a Chrome trace when
    ``CVT_PROFILE=<dir>`` is set, else nothing."""
    out_dir = os.environ.get("CVT_PROFILE")
    if not out_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(out_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(out_dir, f"{name}.trace.json"))


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------


class SpanRecord(NamedTuple):
    """A finished span.  ``tid`` is ``threading.get_ident()`` of the thread
    it nested on, the id the profiler stamps on that thread's launches (as
    a 32-bit ``device_resource_id``); None for a span that ``since``
    closed, which may end on another thread than it began and holds no
    launches.  Times are ``time.perf_counter_ns()``."""

    id: int
    parent: Optional[int]
    name: str
    tid: Optional[int]
    start_ns: int
    end_ns: int
    attrs: dict


RECORDING = 0  # open recording() blocks; read it, do not set it
_recording_lock = threading.Lock()
_spans: list = []  # SpanRecord fields as plain tuples, the cheaper to make
_span_ids = itertools.count(1)
_local = threading.local()


class _NoSpan:
    """The shared no-op context of ``span`` outside ``recording()``
    (``contextlib.nullcontext`` costs a third more a use)."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return None


_NOOP = _NoSpan()


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


@contextlib.contextmanager
def recording():
    """Keep the spans that open inside the block, on every thread."""
    global RECORDING
    with _recording_lock:
        RECORDING += 1
    try:
        yield
    finally:
        with _recording_lock:
            RECORDING -= 1


def drain() -> List[SpanRecord]:
    """The spans kept so far, in the order they ended; they are cleared."""
    n = len(_spans)
    out = _spans[:n]
    del _spans[:n]
    return [SpanRecord(*r) for r in out]


class Span:
    """A named interval on the calling thread.  It always reads its clock,
    so ``seconds()`` is there to read (a served call's time); it is kept,
    with its parent, only when it opens inside ``recording()``."""

    __slots__ = ("name", "attrs", "start_ns", "end_ns", "_id", "_parent", "_stack")

    def __init__(self, name: str, **attrs):
        self.name, self.attrs = name, attrs
        self.start_ns = self.end_ns = self._stack = None

    def __enter__(self):
        if RECORDING:
            stack = self._stack = _stack()
            self._parent = stack[-1] if stack else None
            self._id = next(_span_ids)
            stack.append(self._id)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.perf_counter_ns()
        if self._stack is not None:
            self._stack.pop()
            _spans.append((self._id, self._parent, self.name, threading.get_ident(),
                           self.start_ns, self.end_ns, self.attrs))
        return False

    def seconds(self) -> float:
        """From the start to the end, or to now while the span is open."""
        end = time.perf_counter_ns() if self.end_ns is None else self.end_ns
        return (end - self.start_ns) / 1e9


def span(name: str, **attrs):
    """A ``Span`` inside ``recording()``, else a shared no-op context."""
    return Span(name, **attrs) if RECORDING else _NOOP


def mark() -> Optional[int]:
    """Now, in ``perf_counter_ns``, inside ``recording()``; else None: the
    start of a span that ``since`` closes, on any thread."""
    return time.perf_counter_ns() if RECORDING else None


def since(name: str, start_ns: Optional[int], **attrs):
    """Keep the span from a ``mark`` to now, with no parent and no thread
    (a request's wait in a queue); nothing for a None mark."""
    if start_ns is not None:
        _spans.append((next(_span_ids), None, name, None, start_ns, time.perf_counter_ns(),
                       attrs))


# ---------------------------------------------------------------------------
# stage timer
# ---------------------------------------------------------------------------


def _sync():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class StageTimer:
    """Wall-clock seconds per pipeline stage.  The clock is read after a
    device sync at both ends of a stage, so queued GPU work counts in the
    stage that queued it.  Each stage is also a ``span`` (inside the
    syncs).  A timer made with ``enabled=False`` neither syncs nor reads
    the clock (``generate`` without ``stage_times``): its stages are spans
    alone."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.stages: Dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str, **attrs):
        if not self.enabled:
            with span(name, **attrs):
                yield
            return
        _sync()
        t0 = time.perf_counter()
        try:
            with span(name, **attrs):
                yield
        finally:
            _sync()
            self.stages[name] = self.stages.get(name, 0.0) + time.perf_counter() - t0

    def report(self) -> Dict[str, float]:
        total = sum(self.stages.values()) or 1.0
        rep = {k: round(v, 3) for k, v in self.stages.items()}
        rep["_shares"] = {k: f"{100 * v / total:.1f}%" for k, v in self.stages.items()}
        return rep
