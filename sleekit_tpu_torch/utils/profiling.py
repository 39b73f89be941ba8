"""Tracing and timing (port of ``sleekit_tpu/utils/profiling.py``).

* :class:`Timer` - named wall-clock sections with a JSON-able report;
  ``timed`` waits for a tensor's device where JAX blocks until ready.
* :func:`device_trace` - a ``torch.profiler`` trace (CPU, and the card's
  kernels where there is one) written as a Chrome trace;
  :func:`trace_summary` sums its device time by kernel.
* :func:`cuda_ms` - a function's device time between CUDA events, its calls
  captured in a CUDA graph and replayed; :func:`time_ms` takes it on the
  card and the host clock on the CPU. The benches and ``chip_smoke.py``
  time with these.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Callable, Dict, Optional

import torch


def _sync(value) -> None:
    """Wait for the CUDA devices holding the tensors in ``value`` (a
    tensor, or a list, tuple or dict of them)."""
    if isinstance(value, torch.Tensor):
        if value.is_cuda:
            torch.cuda.synchronize(value.device)
    elif isinstance(value, dict):
        for v in value.values():
            _sync(v)
    elif isinstance(value, (list, tuple)):
        for v in value:
            _sync(v)


class Timer:
    """Named wall-clock section timers with a JSON-able report.

    ``timed`` sections wait for the device of the value they are given, so
    the asynchronous launch does not hide device time.
    """

    def __init__(self):
        self.sections: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    def _add(self, name: str, dt: float) -> None:
        self.sections[name] = self.sections.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1

    @contextlib.contextmanager
    def section(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._add(name, time.perf_counter() - t0)

    def timed(self, name: str, value):
        """Record the time to materialize ``value`` under ``name``."""
        t0 = time.perf_counter()
        _sync(value)
        self._add(name, time.perf_counter() - t0)
        return value

    def report(self) -> Dict[str, dict]:
        return {k: {"total_s": round(v, 4), "count": self.counts[k],
                    "mean_s": round(v / self.counts[k], 4)}
                for k, v in sorted(self.sections.items(),
                                   key=lambda kv: -kv[1])}

    def dump(self, path: Optional[str] = None) -> str:
        s = json.dumps(self.report(), indent=2)
        if path:
            with open(path, "w") as f:
                f.write(s)
        return s


@contextlib.contextmanager
def device_trace(logdir: str):
    """``torch.profiler`` over the body (the CPU, and CUDA when present);
    yields the profiler, whose ``key_averages()`` sums time by op, and
    writes ``<logdir>/trace.json`` (chrome://tracing, Perfetto) at exit."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def trace_summary(prof, top: int = 12) -> dict:
    """What a :func:`device_trace` saw: ``device_ms``, the self time of
    every device entry (kernels, copies, sets); ``kernels``, the ``top``
    of them as ``[name, ms, calls]`` by time; ``ops``, the calls of each
    host-side ``aten::`` op. Without device entries (the CPU) ``device_ms``
    is 0 and ``kernels`` empty."""
    device, ops = [], {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            device.append([e.key, e.self_device_time_total / 1e3, e.count])
        elif e.key.startswith("aten::"):
            ops[e.key] = ops.get(e.key, 0) + e.count
    device.sort(key=lambda row: -row[1])
    return {"device_ms": sum(row[1] for row in device),
            "kernels": device[:top], "ops": ops}


def cuda_ms(fn: Callable[[int], object], n_args: int, iters: int = 20,
            warmup: int = 3, graph: bool = True) -> float:
    """Mean time of ``fn(i)`` over ``iters`` calls, i cycling over
    ``n_args`` argument sets (so weights larger in total than L2 arrive
    cold, as they do layer after layer), between CUDA events. With
    ``graph`` the calls are captured in a CUDA graph and replayed, so the
    time is the device's alone, free of Python launch overhead; without
    it (the plain versions, which copy host scalars) it is eager."""
    for i in range(warmup):
        fn(i % n_args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for i in range(iters):
                fn(i % n_args)
        g.replay()
        torch.cuda.synchronize()
        start.record()
        g.replay()
    else:
        start.record()
        for i in range(iters):
            fn(i % n_args)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def time_ms(fn: Callable[[int], object], n_args: int, device: torch.device,
            iters: int = 20, graph: bool = True) -> float:
    """:func:`cuda_ms` on a CUDA ``device``; on the CPU, the host clock
    over ``iters`` calls after one warm-up call (a CPU time, never a
    device metric)."""
    if device.type == "cuda":
        return cuda_ms(fn, n_args, iters=iters, graph=graph)
    fn(0)
    t0 = time.perf_counter()
    for i in range(iters):
        fn(i % n_args)
    return (time.perf_counter() - t0) / iters * 1e3
