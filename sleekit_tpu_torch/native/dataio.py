"""SKT1 token shards through ``dataio.cpp`` (port of
``sleekit_tpu/native/dataio.py``).

:func:`write_shard` writes a shard; :class:`TokenShard` memory-maps one and
``windows()`` gathers (batch, seq_len) int32 windows with a multithreaded
native gather; :class:`Prefetcher` keeps a ring of ready batches filled by
a native background thread, so host IO runs ahead of the device.
``models/data.py`` ``load_token_stream`` reads ``.skt`` sources through
:class:`TokenShard`.

The format: the magic ``SKT1``, u32 token size (2 or 4), u64 token count,
then the little-endian tokens. There is no fallback: the library builds at
first use (``native.build_lib``) and a failed build raises. The numpy
versions :func:`write_shard_plain` and :func:`windows_plain` (a memmap)
are the plain versions the tests hold the native ones to.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from sleekit_tpu_torch.native import load_lib

MAGIC = b"SKT1"


def _bind(lib: ctypes.CDLL) -> None:
    i64, i32 = ctypes.c_int64, ctypes.c_int32
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    lib.skt_write.argtypes = [ctypes.c_char_p, i32p, i64, i32]
    lib.skt_write.restype = i32
    lib.skt_open.argtypes = [ctypes.c_char_p]
    lib.skt_open.restype = i64
    lib.skt_len.argtypes = [i64]
    lib.skt_len.restype = i64
    lib.skt_close.argtypes = [i64]
    lib.skt_close.restype = i32
    lib.skt_fill_windows.argtypes = [i64, i64p, i64, i64, i32p]
    lib.skt_fill_windows.restype = i32
    lib.skt_prefetch_start.argtypes = [i64, i64, i64, i64, i64, i64]
    lib.skt_prefetch_start.restype = i64
    lib.skt_prefetch_next.argtypes = [i64, i32p]
    lib.skt_prefetch_next.restype = i32
    lib.skt_prefetch_stop.argtypes = [i64]
    lib.skt_prefetch_stop.restype = i32


def get_lib() -> ctypes.CDLL:
    """The shard library (built at the first call)."""
    return load_lib("dataio.cpp", _bind)


def _token_size(tokens: np.ndarray, dtype_size: Optional[int]) -> int:
    if dtype_size is None:
        return 2 if tokens.size == 0 or int(tokens.max()) < 65536 else 4
    if dtype_size not in (2, 4):
        raise ValueError(f"token size {dtype_size}, not 2 or 4")
    return dtype_size


def write_shard(path: str, tokens: np.ndarray,
                dtype_size: Optional[int] = None) -> None:
    """Write an SKT1 token shard (u16 tokens when the vocab fits, else
    u32)."""
    tokens = np.ascontiguousarray(tokens, np.int32).reshape(-1)
    size = _token_size(tokens, dtype_size)
    rc = get_lib().skt_write(path.encode(), tokens, tokens.size, size)
    if rc != 0:
        raise OSError(f"{path}: writing the shard failed ({rc})")


def write_shard_plain(path: str, tokens: np.ndarray,
                      dtype_size: Optional[int] = None) -> None:
    """numpy version of :func:`write_shard` (the same bytes)."""
    tokens = np.ascontiguousarray(tokens, np.int32).reshape(-1)
    size = _token_size(tokens, dtype_size)
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(np.uint32(size).astype("<u4").tobytes())
        f.write(np.uint64(tokens.size).astype("<u8").tobytes())
        f.write(tokens.astype("<u2" if size == 2 else "<u4").tobytes())


def read_header(path: str):
    """(token size, token count) of an SKT1 shard; ValueError if it is
    not one."""
    with open(path, "rb") as f:
        head = f.read(16)
    if len(head) < 16 or head[:4] != MAGIC:
        raise ValueError(f"{path}: not an SKT1 shard")
    size = int(np.frombuffer(head[4:8], "<u4")[0])
    if size not in (2, 4):
        raise ValueError(f"{path}: token size {size}, not 2 or 4")
    return size, int(np.frombuffer(head[8:16], "<u8")[0])


def windows_plain(path: str, starts, seq_len: int) -> np.ndarray:
    """numpy version of :meth:`TokenShard.windows`: the windows gathered
    from a memmap of the shard."""
    size, count = read_header(path)
    starts = np.asarray(starts, np.int64)
    if count == 0:
        raise ValueError(f"{path}: the shard holds no tokens")
    mm = np.memmap(path, dtype="<u2" if size == 2 else "<u4", mode="r",
                   offset=16, shape=(count,))
    idx = (starts[:, None] % count + np.arange(seq_len)[None, :]) % count
    out = mm[idx].astype(np.int32)
    del mm
    return out


# skt_open's failures: a missing or unreadable file, a file shorter than a
# header, a failed mmap, a wrong magic, a bad token size or a payload
# shorter than the count.
_OPEN_ERRORS = {-1: "cannot open it", -2: "not an SKT1 shard",
                -3: "mmap failed", -4: "not an SKT1 shard",
                -5: "not an SKT1 shard (bad token size or truncated)"}


class TokenShard:
    """A memory-mapped SKT1 shard; batches assembled natively."""

    def __init__(self, path: str):
        self.path = path
        self._lib = get_lib()
        h = self._lib.skt_open(path.encode())
        if h < 0:
            err = ValueError if h in (-2, -4, -5) else OSError
            raise err(f"{path}: {_OPEN_ERRORS.get(h, h)}")
        self._handle = int(h)
        self._len = int(self._lib.skt_len(h))

    def __len__(self) -> int:
        return self._len

    def _live(self) -> int:
        if self._handle < 0:
            raise ValueError(f"{self.path}: the shard is closed")
        return self._handle

    def windows(self, starts, seq_len: int) -> np.ndarray:
        """Gather len(starts) windows of seq_len tokens (wrapping at the
        shard's end): (len(starts), seq_len) int32."""
        starts = np.ascontiguousarray(starts, np.int64)
        out = np.empty((len(starts), seq_len), np.int32)
        if out.size == 0:
            return out
        rc = self._lib.skt_fill_windows(self._live(), starts, len(starts),
                                        seq_len, out)
        if rc != 0:
            raise ValueError(f"{self.path}: gathering windows failed ({rc}; "
                             "-2: the shard holds no tokens)")
        return out

    def batches(self, n_batches: int, batch: int, seq_len: int,
                stride: Optional[int] = None, start: int = 0):
        """Sequential (batch, seq_len) windows - the calibration feed."""
        stride = stride or seq_len
        pos = start
        for _ in range(n_batches):
            starts = pos + stride * np.arange(batch, dtype=np.int64)
            yield self.windows(starts, seq_len)
            pos += stride * batch

    def close(self) -> None:
        """Unmap the shard (stop its prefetchers first)."""
        if self._handle >= 0:
            self._lib.skt_close(self._handle)
            self._handle = -1

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class Prefetcher:
    """Background-thread batch pipeline over a TokenShard: a native thread
    fills a ring of ``depth`` ready batches, in the order of
    :meth:`TokenShard.batches`; ``next()`` copies one out."""

    def __init__(self, shard: TokenShard, batch: int, seq_len: int,
                 stride: Optional[int] = None, start: int = 0,
                 depth: int = 4):
        self.shard = shard
        self.batch, self.seq_len = batch, seq_len
        self.stride = stride or seq_len
        pf = shard._lib.skt_prefetch_start(shard._live(), batch, seq_len,
                                           self.stride, start, depth)
        if pf < 0:
            raise ValueError(f"{shard.path}: the prefetcher did not start "
                             f"({pf}; -2: an empty shard or a batch, "
                             "window or depth below 1)")
        self._pf = int(pf)

    def next(self) -> np.ndarray:
        if self._pf < 0:
            raise ValueError("the prefetcher is stopped")
        out = np.empty((self.batch, self.seq_len), np.int32)
        rc = self.shard._lib.skt_prefetch_next(self._pf, out)
        if rc != 0:
            raise RuntimeError(f"skt_prefetch_next returned {rc}")
        return out

    def stop(self) -> None:
        """Stop and join the native thread (idempotent)."""
        if self._pf >= 0:
            self.shard._lib.skt_prefetch_stop(self._pf)
            self._pf = -1

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
