"""The port's ``load_token_stream`` against the JAX package's (mirrors
tests/test_data.py): ``.npy`` streams, SKT1 shards written by the JAX
package's ``write_shard`` (u16 and u32 tokens, read here through a numpy
memmap), the synthetic stream for ``None``, and an unknown source
refused; the same tokens and provenance, and the same calibration
batches cut from each."""

import numpy as np
import pytest

from sleekit_tpu.models import data as jdata
from sleekit_tpu.native.dataio import write_shard
from sleekit_tpu_torch.models import data as tdata


def _same(source, vocab, n, **kw):
    got = tdata.load_token_stream(source, vocab, n, **kw)
    want = jdata.load_token_stream(source, vocab, n, **kw)
    assert got[1] == want[1]
    assert got[0].dtype == want[0].dtype == np.int32
    np.testing.assert_array_equal(got[0], want[0])
    for samples, seq_len, batch in ((4, 16, 2), (3, 32, 2)):
        gb = tdata.calibration_batches(got[0], samples, seq_len, batch)
        wb = jdata.calibration_batches(want[0], samples, seq_len, batch)
        assert len(gb) == len(wb)
        for g, w in zip(gb, wb):
            np.testing.assert_array_equal(g, w)
    return got


@pytest.mark.parametrize("n", [50, 500])
def test_npy_stream(tmp_path, n):
    stream = np.random.default_rng(0).integers(0, 1000, 300).astype(np.int64)
    path = tmp_path / "toks.npy"
    np.save(path, stream)
    toks, prov = _same(str(path), 1000, n)
    assert prov == f"file:{path}"
    np.testing.assert_array_equal(toks, stream[:n].astype(np.int32))


@pytest.mark.parametrize("vocab", [1000, 100_000])
@pytest.mark.parametrize("n", [64, 5000])
def test_skt_shard(tmp_path, vocab, n):
    """A shard of u16 tokens (vocab < 2^16) or u32 ones; ``n`` within the
    shard and past its end (the stream stops at the shard's length)."""
    stream = np.random.default_rng(1).integers(0, vocab, 1000).astype(
        np.int32)
    path = str(tmp_path / "toks.skt")
    write_shard(path, stream)
    toks, prov = _same(path, vocab, n)
    assert prov == f"shard:{path}"
    np.testing.assert_array_equal(toks, stream[:n])


def test_synthetic_and_unknown_source(tmp_path):
    toks, prov = _same(None, 512, 128, seed=3)
    assert prov == "synthetic" and len(toks) == 128
    np.testing.assert_array_equal(toks, tdata.synthetic_stream(512, 128, 3))
    for source in ("tokens.txt", str(tmp_path / "missing.bin")):
        for mod in (tdata, jdata):
            with pytest.raises(ValueError, match="unrecognized token source"):
                mod.load_token_stream(source, 512, 128)
    bad = tmp_path / "bad.skt"
    bad.write_bytes(b"NOPE" + bytes(12))
    with pytest.raises(ValueError, match="not an SKT1 shard"):
        tdata.load_token_stream(str(bad), 512, 8)
