"""The port's native token-shard loader (``sleekit_tpu_torch/native/
dataio.py``) against the JAX package's (``sleekit_tpu/native/dataio.py``)
and its own plain version (a numpy memmap): shards written by either
package read the same in the other (u16 and u32 tokens), ``windows`` and
``batches``, the ``Prefetcher`` against the synchronous batches, and
``load_token_stream('.skt')`` through ``TokenShard.windows``."""

import threading

import numpy as np
import pytest

from sleekit_tpu.models import data as jdata
from sleekit_tpu.native import dataio as jio
from sleekit_tpu_torch.models import data as tdata
from sleekit_tpu_torch.native import dataio as tio


def _tokens(vocab, n=1000, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, n).astype(np.int32)


@pytest.mark.parametrize("vocab,size", [(1000, 2), (100_000, 4)])
def test_shards_read_the_same_in_either_package(tmp_path, vocab, size):
    """The port's native and plain writers write the JAX package's bytes;
    each package's TokenShard reads the other's shard to the same
    windows."""
    toks = _tokens(vocab)
    paths = {name: str(tmp_path / f"{name}.skt")
             for name in ("jax", "port", "plain")}
    jio.write_shard(paths["jax"], toks)
    tio.write_shard(paths["port"], toks)
    tio.write_shard_plain(paths["plain"], toks)
    raw = {k: open(p, "rb").read() for k, p in paths.items()}
    assert raw["port"] == raw["jax"] == raw["plain"]
    assert len(raw["port"]) == 16 + size * toks.size
    assert tio.read_header(paths["port"]) == (size, toks.size)
    starts = np.array([0, 17, 990, 2500], np.int64)
    with tio.TokenShard(paths["jax"]) as ours:
        theirs = jio.TokenShard(paths["port"])
        assert len(ours) == len(theirs) == toks.size
        got = ours.windows(starts, 40)
        np.testing.assert_array_equal(got, theirs.windows(starts, 40))
        theirs.close()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got[0], toks[:40])
    # Windows wrap at the shard's end.
    np.testing.assert_array_equal(got[2], np.concatenate([toks[990:],
                                                          toks[:30]]))


@pytest.mark.parametrize("vocab", [1000, 100_000])
def test_windows_and_batches_match_jax_and_plain(tmp_path, vocab):
    """``windows`` and ``batches`` (strided, from an offset, wrapping) equal
    the JAX package's and the plain memmap version's."""
    toks = _tokens(vocab, 777, seed=1)
    path = str(tmp_path / "toks.skt")
    tio.write_shard(path, toks)
    starts = np.array([5, 700, 776, 1554, 3], np.int64)
    jshard = jio.TokenShard(path)
    with tio.TokenShard(path) as shard:
        got = shard.windows(starts, 123)
        np.testing.assert_array_equal(got, jshard.windows(starts, 123))
        np.testing.assert_array_equal(got, tio.windows_plain(path, starts,
                                                             123))
        kw = dict(stride=50, start=9)
        ours = list(shard.batches(6, 4, 32, **kw))
        want = list(jshard.batches(6, 4, 32, **kw))
        assert len(ours) == len(want) == 6
        for i, (g, w) in enumerate(zip(ours, want)):
            np.testing.assert_array_equal(g, w)
            plain_starts = 9 + 50 * (4 * i + np.arange(4))
            np.testing.assert_array_equal(
                g, tio.windows_plain(path, plain_starts, 32))
        assert shard.windows(starts, 0).shape == (5, 0)
    jshard.close()
    with pytest.raises(ValueError, match="closed"):
        shard.windows(starts, 4)


def _in_thread(fn, timeout=60):
    """fn() on a daemon thread joined with a timeout: a hang fails the
    test instead of holding the run."""
    box = {}

    def run():
        try:
            box["out"] = fn()
        except BaseException as e:  # noqa: BLE001 - re-raised below
            box["err"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout)
    assert not t.is_alive(), "the prefetcher hung"
    if "err" in box:
        raise box["err"]
    return box["out"]


@pytest.mark.parametrize("stride,depth", [(None, 4), (13, 1), (64, 3)])
def test_prefetcher_equals_the_sync_batches(tmp_path, stride, depth):
    """The native prefetch thread's batches, in order, are the synchronous
    ``batches`` (and the JAX package's prefetcher's); ``stop`` is
    idempotent and a stopped prefetcher refuses ``next``."""
    toks = _tokens(5000, 500, seed=2)
    path = str(tmp_path / "toks.skt")
    tio.write_shard(path, toks)

    def drain():
        with tio.TokenShard(path) as shard:
            want = list(shard.batches(9, 3, 24, stride=stride, start=11))
            with tio.Prefetcher(shard, 3, 24, stride=stride, start=11,
                                depth=depth) as pf:
                got = [pf.next() for _ in range(9)]
            pf.stop()
            with pytest.raises(ValueError, match="stopped"):
                pf.next()
        jshard = jio.TokenShard(path)
        with jio.Prefetcher(jshard, 3, 24, stride=stride, start=11,
                            depth=depth) as jpf:
            theirs = [jpf.next() for _ in range(9)]
        jshard.close()
        return got, want, theirs

    got, want, theirs = _in_thread(drain)
    for g, w, t in zip(got, want, theirs):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, t)


@pytest.mark.parametrize("vocab,n", [(1000, 64), (100_000, 600),
                                     (1000, 5000)])
def test_load_token_stream_skt_reads_through_the_native_loader(
        tmp_path, monkeypatch, vocab, n):
    """``load_token_stream`` on an ``.skt`` shard gives the JAX package's
    tokens and provenance, through ``TokenShard.windows`` once; its plain
    version (the memmap) gives the same tokens."""
    toks = _tokens(vocab, 600, seed=3)
    path = str(tmp_path / "toks.skt")
    jio.write_shard(path, toks)
    calls = []
    windows = tio.TokenShard.windows
    monkeypatch.setattr(tio.TokenShard, "windows",
                        lambda self, *a: calls.append(a) or windows(self, *a))
    got, prov = tdata.load_token_stream(path, vocab, n)
    want, jprov = jdata.load_token_stream(path, vocab, n)
    assert prov == jprov == f"shard:{path}" and len(calls) == 1
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, toks[:n])
    np.testing.assert_array_equal(tdata.read_token_shard_plain(path, n), got)


def test_bad_and_empty_shards(tmp_path):
    """A wrong magic, a bad token size or a truncated payload raise
    ValueError, a missing file OSError; an empty shard has length 0,
    refuses windows and a prefetcher, and streams no tokens."""
    bad = tmp_path / "bad.skt"
    bad.write_bytes(b"NOPE" + bytes(12))
    short = tmp_path / "short.skt"
    short.write_bytes(b"SKT1")
    size3 = tmp_path / "size3.skt"
    size3.write_bytes(b"SKT1" + np.uint32(3).tobytes()
                      + np.uint64(0).tobytes())
    cut = tmp_path / "cut.skt"
    tio.write_shard(str(cut), _tokens(1000, 100))
    cut.write_bytes(cut.read_bytes()[:-2])
    for path in (bad, short, size3, cut):
        with pytest.raises(ValueError, match="not an SKT1 shard"):
            tio.TokenShard(str(path))
    for path in (bad, short, size3):
        with pytest.raises(ValueError):
            tio.read_header(str(path))
    with pytest.raises(OSError):
        tio.TokenShard(str(tmp_path / "missing.skt"))
    empty = str(tmp_path / "empty.skt")
    tio.write_shard(empty, np.zeros(0, np.int32))
    assert open(empty, "rb").read() == (b"SKT1" + np.uint32(2).tobytes()
                                        + np.uint64(0).tobytes())
    with tio.TokenShard(empty) as shard:
        assert len(shard) == 0
        with pytest.raises(ValueError, match="no tokens"):
            shard.windows(np.zeros(1, np.int64), 4)
        with pytest.raises(ValueError, match="did not start"):
            tio.Prefetcher(shard, 1, 4)
    toks, prov = tdata.load_token_stream(empty, 1000, 16)
    assert toks.size == 0 and prov == f"shard:{empty}"
    assert tdata.read_token_shard_plain(empty, 16).size == 0
    with pytest.raises(ValueError, match="token size"):
        tio.write_shard(str(tmp_path / "x.skt"), np.zeros(3, np.int32), 3)
