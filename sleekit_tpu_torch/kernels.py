"""Build and bind the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on its own
by ``nvcc`` for ``sm_90a`` into ``_build/<name>-<hash>.so`` (the hash
covers the source, the shared headers and the flags, so an edited source
rebuilds), then loaded with ``ctypes``. Nothing is built or loaded when
this module is imported: a kernel builds at its first launch, or all of
them at once, in parallel, through :func:`build`.

Every C entry takes PyTorch's current stream as its last argument and
returns ``cudaGetLastError()``; :class:`CudaKernel` raises if that is not
0 and counts the launches that succeeded. A call made while a CUDA graph
is captured launches nothing: :func:`captured_launches` takes such calls
out of the counts, and :func:`add_launches` counts them again at each
replay of the graph.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
# No --use_fast_math: the int8 KV quantization divides by its scale and
# must round exactly as the reference does.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

KERNELS: List["CudaKernel"] = []
_LIBS: Dict[Path, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built by "
                           "the CUDA toolkit on the machine with the card")
    return path


def library_path(source: str) -> Path:
    """Where ``csrc/<source>`` builds to; the name changes with its text."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [CSRC / source] + sorted(CSRC.glob("*.cuh")):
        h.update(path.read_bytes())
    return BUILD_DIR / f"{Path(source).stem}-{h.hexdigest()[:16]}.so"


def build(sources: Optional[Sequence[str]] = None,
          ptxas_verbose: bool = False) -> Dict[str, dict]:
    """Compile every source that has no current library, one ``nvcc`` per
    source, all started together. Returns ``{source: {"seconds", "log"}}``
    for the ones it built; raises with nvcc's output if one fails."""
    sources = sources or sorted(p.name for p in CSRC.glob("*.cu"))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for src in sources:
        out = library_path(src)
        if out.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp,
               str(CSRC / src)]
        if ptxas_verbose:
            cmd[1:1] = ["-Xptxas", "-v"]
        procs[src] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, out, time.perf_counter())
    done = {}
    failed = []
    for src, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{src}:\n{log}")
            os.unlink(tmp)
            continue
        os.replace(tmp, out)
        done[src] = {"seconds": time.perf_counter() - t0, "log": log}
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return done


def _load(source: str) -> ctypes.CDLL:
    path = library_path(source)
    if path not in _LIBS:
        if not path.exists():
            build([source])
        _LIBS[path] = ctypes.CDLL(str(path))
    return _LIBS[path]


class CudaKernel:
    """One C entry of one ``csrc`` source, with its launch count.

    ``argtypes`` lists the entry's arguments without the trailing stream;
    pointers are ``c_void_p`` (pass ``tensor.data_ptr()`` or 0)."""

    def __init__(self, name: str, source: str, symbol: str,
                 argtypes: Sequence, replaces: str):
        self.name = name
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes) + [ctypes.c_void_p]
        self.replaces = replaces
        self.launches = 0
        self._fn = None
        KERNELS.append(self)

    def __call__(self, *args) -> None:
        if self._fn is None:
            fn = getattr(_load(self.source), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        err = self._fn(*args, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"{self.name} ({self.symbol}): CUDA error "
                               f"{err} at launch")
        self.launches += 1


# Int32 tickets a device, 0 between launches: a kernel that combines its
# blocks' partial sums by ticket (one a (batch row, KV head) in
# ``decode_attention.cu``, one a column strip in ``plane_f32.cu``) has
# the block that takes the last ticket reset it, so a graph replays with
# no reset pass. Launches that share them run on one stream. A buffer
# outgrown is kept, since a captured graph may still point at it.
_TICKETS: Dict[torch.device, List[torch.Tensor]] = {}


def zeroed_tickets(n: int, dev) -> torch.Tensor:
    """At least ``n`` int32 tickets on ``dev``, 0 between launches."""
    held = _TICKETS.setdefault(dev, [])
    if not held or held[-1].numel() < n:
        held.append(torch.zeros(max(n, 4096), dtype=torch.int32,
                                device=dev))
    return held[-1]


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


@contextlib.contextmanager
def captured_launches():
    """Yields a dict that, when the block ends, holds ``{kernel: calls}``
    for the kernels called in the block; those calls leave the counts
    (the block captures a CUDA graph, which runs nothing)."""
    before = [k.launches for k in KERNELS]
    calls: Dict[CudaKernel, int] = {}
    try:
        yield calls
    finally:
        for k, n in zip(KERNELS, before):
            if k.launches != n:
                calls[k] = k.launches - n
            k.launches = n


def add_launches(calls: Dict[CudaKernel, int], times: int = 1) -> None:
    """Count ``times`` replays of a graph whose capture made ``calls``
    (:func:`captured_launches`)."""
    for k, n in calls.items():
        k.launches += n * times


if __name__ == "__main__":
    # python -m sleekit_tpu_torch.kernels: build every source now and print
    # ptxas's register / shared-memory / spill report for each kernel.
    for src, info in build(ptxas_verbose=True).items():
        print(f"== {src}: {info['seconds']:.1f} s\n{info['log']}")
