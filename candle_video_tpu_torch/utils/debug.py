"""Observability (``candle_video_tpu/utils/debug.py``): structured logging,
tensor dumps and profiling, each gated by an environment variable.

- ``log``: one JSON line on stderr a record, gated by ``CVT_LOG``
  (``off`` | ``info`` | ``debug``);
- ``dump_tensor``: with ``CVT_DUMP_TENSORS=<dir>``, each call writes the
  tensor as f32 to ``<dir>/NNN_<name>[_stepS].safetensors`` under the key
  ``tensor``, through the port's own writer (``loader.save_safetensors``);
- ``trace``: with ``CVT_PROFILE=<dir>``, a ``torch.profiler`` window (CPU,
  and CUDA where there is a GPU) exported as a Chrome trace to
  ``<dir>/<name>.trace.json``; a no-op without it;
- ``StageTimer``: wall-clock seconds per named stage, read after the GPU's
  queued work has finished.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import sys
import time
from typing import Dict, Optional

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


def _sync():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class StageTimer:
    """Wall-clock seconds per pipeline stage.  The clock is read after a
    device sync at both ends of a stage, so queued GPU work counts in the
    stage that queued it.  A timer made with ``enabled=False`` neither
    syncs nor reads the clock (``generate`` without ``stage_times``)."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.stages: Dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        if not self.enabled:
            yield
            return
        _sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            _sync()
            self.stages[name] = self.stages.get(name, 0.0) + time.perf_counter() - t0

    def report(self) -> Dict[str, float]:
        total = sum(self.stages.values()) or 1.0
        rep = {k: round(v, 3) for k, v in self.stages.items()}
        rep["_shares"] = {k: f"{100 * v / total:.1f}%" for k, v in self.stages.items()}
        return rep
