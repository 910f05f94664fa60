"""Profiling and tracing hooks (port of incarnation_tpu/utils/profiling.py
on torch.profiler and CUDA events).

The reference instruments every pass with PIX + Tracy scoped zones and GPU
timelines per queue (ref: inc/profiling.h:10-12, src/profiling.cpp,
backend-d3d12.cpp:1727-1737). Here:

- `scoped(name)`: a torch.profiler.record_function region, and an NVTX
  range when CUDA is present, so traces group kernels per render pass.
- `trace(dir)`: torch.profiler over the block (CPU, and CUDA when present),
  written as a Chrome trace (the Tracy-capture analogue).
- `time_fn(fn, *args)`: seconds per call, by CUDA events on the card and
  by the clock on the CPU (the render-stats timing analogue).
"""

from __future__ import annotations

import contextlib
import pathlib
import time

import torch


@contextlib.contextmanager
def scoped(name: str):
    """`with profiling.scoped("visibility_pass"): ...`, the
    SCOPED_COMMAND_LIST_EVENT analogue."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


@contextlib.contextmanager
def trace(log_dir="incarnation_trace"):
    """Profile the block and write `<log_dir>/trace.json` (Chrome trace
    format: chrome://tracing, Perfetto). Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = pathlib.Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(out / "trace.json"))


def _on_card(out) -> bool:
    """Whether out (a tensor, or a dict, list or tuple of them) holds a
    CUDA tensor."""
    items = (out.values() if isinstance(out, dict)
             else out if isinstance(out, (list, tuple)) else [out])
    return any(torch.is_tensor(t) and t.is_cuda for t in items)


def time_fn(fn, *args, iters: int = 5, warmup: int = 1):
    """-> (seconds per call, last output): CUDA events around the calls
    when the output lives on the card, else the host clock."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    if _on_card(out):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            out = fn(*args)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / 1e3 / iters, out
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    return (time.perf_counter() - t0) / iters, out
