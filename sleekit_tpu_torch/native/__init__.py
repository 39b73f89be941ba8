"""Native (C++) host-side helpers, bound through ctypes (port of
``sleekit_tpu/native/__init__.py``; the port keeps its own copies of the
sources, ``packing.cpp`` and ``dataio.cpp``).

* :func:`pack_indices_np`, :func:`unpack_indices_np` - multithreaded
  sub-byte packing of (K, N) indices into the 'linear' words of
  ``ops/pack.py`` and back;
* :func:`quantize_pack_uniform_np` - round onto a uniform codebook's grid
  and pack in one pass (checkpoint conversion);
* ``dataio`` - SKT1 token shards (:mod:`.dataio`).

Each library builds with the host's C++ compiler (``$CXX``, default
``g++``) at its first use, into the git-ignored ``sleekit_tpu_torch/_build/``
under a name that carries the hash of its source, flags and compiler. There
is no fallback: a build that fails raises with the compiler's output. The
numpy versions beside the native ones (``*_plain``) are the plain versions
the tests hold them to.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict

import numpy as np

HERE = Path(__file__).resolve().parent
BUILD_DIR = HERE.parent / "_build"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-pthread"]

_lock = threading.Lock()
_LIBS: Dict[Path, ctypes.CDLL] = {}


def _cxx() -> str:
    return os.environ.get("CXX", "g++")


def library_path(source: str) -> Path:
    """Where ``native/<source>`` builds to; the name changes with its text,
    the flags and the compiler."""
    h = hashlib.sha256(" ".join([_cxx()] + CXX_FLAGS).encode())
    h.update((HERE / source).read_bytes())
    return BUILD_DIR / f"{Path(source).stem}-{h.hexdigest()[:16]}.so"


def build_lib(source: str) -> Path:
    """Compile ``native/<source>`` into its library unless it is built;
    returns the library's path. Raises RuntimeError, with the compiler's
    output, if the build fails."""
    out = library_path(source)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_cxx(), *CXX_FLAGS, str(HERE / source), "-o", tmp]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        os.unlink(tmp)
        raise RuntimeError(f"building {source} failed: {' '.join(cmd)}: "
                           f"{e}") from e
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"building {source} failed ({' '.join(cmd)}):\n"
                           f"{proc.stderr}{proc.stdout}")
    os.replace(tmp, out)   # atomic: concurrent builds agree
    return out


def load_lib(source: str, bind) -> ctypes.CDLL:
    """The library of ``native/<source>``, built if needed and loaded once
    a process; ``bind(lib)`` sets its entries' argument and result types."""
    path = library_path(source)
    with _lock:
        if path not in _LIBS:
            lib = ctypes.CDLL(str(build_lib(source)))
            bind(lib)
            _LIBS[path] = lib
        return _LIBS[path]


def _bind_packing(lib: ctypes.CDLL) -> None:
    i64, i32 = ctypes.c_int64, ctypes.c_int32
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    lib.skq_pack.argtypes = [u8p, i64, i64, i32, i32p]
    lib.skq_pack.restype = i32
    lib.skq_unpack.argtypes = [i32p, i64, i64, i32, u8p]
    lib.skq_unpack.restype = i32
    lib.skq_quantize_pack_uniform.argtypes = [
        f32p, i64, i64, i32, i32, ctypes.c_float, ctypes.c_float, i32p]
    lib.skq_quantize_pack_uniform.restype = i32


def get_lib() -> ctypes.CDLL:
    """The packing library (built at the first call)."""
    return load_lib("packing.cpp", _bind_packing)


def _vpw(nbits: int) -> int:
    """Sub-elements a word, as ``ops/pack.py`` ``vals_per_word``."""
    if nbits == 3:
        return 10
    if not 1 <= nbits <= 8 or 32 % nbits:
        raise ValueError(f"unsupported pack width {nbits}")
    return 32 // nbits


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: native call returned {rc}")


def pack_indices_np(idx: np.ndarray, nbits: int) -> np.ndarray:
    """(K, N) indices -> (ceil(K / vpw), N) int32 words, the 'linear'
    layout of ``ops/pack.py`` ``pack_indices`` (bit for bit)."""
    kw = -(-idx.shape[0] // _vpw(nbits))
    idx = np.ascontiguousarray(idx, np.uint8)
    k, n = idx.shape
    out = np.empty((kw, n), np.int32)
    if n:
        _check(get_lib().skq_pack(idx, k, n, nbits, out), "skq_pack")
    return out


def unpack_indices_np(words: np.ndarray, nbits: int, k: int) -> np.ndarray:
    """Inverse of :func:`pack_indices_np`: (k, N) int32 indices."""
    _vpw(nbits)
    words = np.ascontiguousarray(words, np.int32)
    n = words.shape[1]
    out = np.empty((k, n), np.uint8)
    if n:
        _check(get_lib().skq_unpack(words, k, n, nbits, out), "skq_unpack")
    return out.astype(np.int32)


def quantize_pack_uniform_np(w_normalized: np.ndarray, nbits: int,
                             levels: int, step: float, zero: float
                             ) -> np.ndarray:
    """Round (K, N) normalized weights onto the grid ``i * step + zero``,
    i in [0, levels), and pack the indices: the checkpoint conversion's
    hot loop in one pass."""
    _vpw(nbits)
    if levels < 2 or not step > 0:
        raise ValueError(f"levels {levels} and step {step}: need levels >= "
                         "2 and step > 0")
    w = np.ascontiguousarray(w_normalized, np.float32)
    k, n = w.shape
    out = np.empty((-(-k // _vpw(nbits)), n), np.int32)
    if n:
        _check(get_lib().skq_quantize_pack_uniform(
            w, k, n, nbits, levels, float(step), float(zero), out),
            "skq_quantize_pack_uniform")
    return out


# ---- plain versions (numpy; the tests hold the native ones to them) -------


def pack_indices_plain(idx: np.ndarray, nbits: int) -> np.ndarray:
    """numpy version of :func:`pack_indices_np`."""
    vpw = _vpw(nbits)
    idx = np.asarray(idx)
    k, n = idx.shape
    kw = -(-k // vpw)
    pad = np.zeros((kw * vpw, n), np.uint32)
    pad[:k] = idx.astype(np.uint32) & np.uint32((1 << nbits) - 1)
    shifts = (np.arange(vpw, dtype=np.uint32) * nbits)[None, :, None]
    return (pad.reshape(kw, vpw, n) << shifts).sum(
        axis=1, dtype=np.uint32).view(np.int32)


def unpack_indices_plain(words: np.ndarray, nbits: int, k: int) -> np.ndarray:
    """numpy version of :func:`unpack_indices_np`."""
    vpw = _vpw(nbits)
    u = np.ascontiguousarray(words, np.int32).view(np.uint32)
    shifts = (np.arange(vpw, dtype=np.uint32) * nbits)[None, :, None]
    sub = (u[:, None, :] >> shifts) & np.uint32((1 << nbits) - 1)
    return sub.reshape(-1, u.shape[1])[:k].astype(np.int32)


def quantize_pack_uniform_plain(w_normalized: np.ndarray, nbits: int,
                                levels: int, step: float, zero: float
                                ) -> np.ndarray:
    """numpy version of :func:`quantize_pack_uniform_np`, in its
    arithmetic: f32 ``(w - zero) * (1 / step)``, rounded half away from
    zero (``lround``), clipped to the grid."""
    w = np.asarray(w_normalized, np.float32)
    inv = np.float32(1.0) / np.float32(step)
    x = ((w - np.float32(zero)) * inv).astype(np.float64)
    q = np.sign(x) * np.floor(np.abs(x) + 0.5)
    return pack_indices_plain(np.clip(q, 0, levels - 1).astype(np.uint8),
                              nbits)
