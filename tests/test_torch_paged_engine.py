"""The paged serving slice as a whole: the port's Engine over the page
pool (K5, or K14 + K15 on the split route) against the JAX package's paged
Engine and the port's slot Engine, on tiny OPT / BLOOM / Llama packed int4
'pair' models carried across with ``params_from_numpy``, f32 activations
(mirrors tests/test_paged_engine.py:22,115,130)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from sleekit_tpu.serve.engine import Engine as JEngine, Request as JRequest
from sleekit_tpu_torch.ops import attention as tattn
from sleekit_tpu_torch.serve.engine import Engine, Request

from tests.test_torch_model import FAMILIES, _models

GEOMETRY = dict(max_slots=3, max_seq_len=64)


def _specs():
    """tests/test_paged_engine.py's request mix: (prompt, new tokens)."""
    rng = np.random.RandomState(0)
    return [(rng.randint(0, 64, n).astype(np.int32), m)
            for n, m in [(5, 12), (19, 4), (3, 30), (40, 8), (7, 7)]]


def _run(engine, request_cls, specs, **kw):
    return [c.new_tokens for c in engine.run(
        [request_cls(prompt=p.copy(), max_new_tokens=m, **kw)
         for p, m in specs])]


def _assert_drained(engine):
    """Every page is back on the free list (all but the trash page) and no
    slot holds pages."""
    assert sorted(engine._free_pages) == list(range(1, engine.total_pages))
    assert not engine._slot_pages
    assert not engine.cache["page_table"].any()


@pytest.mark.parametrize("family,cache", [
    (family, "int8") for family in FAMILIES] + [("opt", "f32")])
def test_paged_engine_matches_jax_and_slot_engine(family, cache):
    """The port's paged Engine emits the JAX paged Engine's greedy tokens
    and the port's slot Engine's, for an int8 (bf16 scales, the serving
    default) and an f32 pool, and returns every page."""
    jcfg, jp, tcfg, tp = _models(family, seed=3)
    jdt, tdt = ((jnp.int8, torch.int8) if cache == "int8"
                else (jnp.float32, torch.float32))
    specs = _specs()
    want = _run(JEngine(jcfg, jp, cache_dtype=jdt, paged=True, page_size=16,
                        **GEOMETRY), JRequest, specs)
    paged = Engine(tcfg, tp, cache_dtype=tdt, paged=True, page_size=16,
                   device="cpu", **GEOMETRY)
    got = _run(paged, Request, specs)
    slot = _run(Engine(tcfg, tp, cache_dtype=tdt, device="cpu", **GEOMETRY),
                Request, specs)
    for g, w, s in zip(got, want, slot):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, s)
    _assert_drained(paged)


def test_paged_pool_smaller_than_worst_case():
    """A pool of 6 pages (5 usable; the 5 requests need 11), int8: FIFO
    admission blocks, pages are recycled (a freed page still holds its
    rows; the s <= pos mask keeps them out), and the tokens are the JAX
    paged Engine's and the slot Engine's."""
    jcfg, jp, tcfg, tp = _models("opt", seed=4)
    specs = _specs()
    kw = dict(max_slots=4, max_seq_len=64)
    want = _run(JEngine(jcfg, jp, cache_dtype=jnp.int8, paged=True,
                        page_size=16, total_pages=6, **kw), JRequest, specs)
    paged = Engine(tcfg, tp, cache_dtype=torch.int8, paged=True,
                   page_size=16, total_pages=6, device="cpu", **kw)
    admitted = []
    admit = paged._admit

    def spy():
        admit()
        admitted.append(sum(r is not None for r in paged.slot_req))

    paged._admit = spy
    got = _run(paged, Request, specs)
    slot = _run(Engine(tcfg, tp, cache_dtype=torch.int8, device="cpu",
                       **kw), Request, specs)
    for g, w, s in zip(got, want, slot):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, s)
    # Admission blocked: never all 5 requests at once in 4 slots' worth of
    # pages, and slots were refilled as pages came back.
    assert max(admitted) < 4
    _assert_drained(paged)


def test_paged_engine_sampled_reproducible():
    """Sampled requests (temperature, top-k) through the paged pool
    reproduce themselves under a seeded generator, equal the slot Engine's
    draws from the same seed (same slot geometry, same logits), and stay
    in the vocabulary (the RNGs differ from JAX's, so no token equality
    with it)."""
    _, _, tcfg, tp = _models("opt", seed=5)
    rng = np.random.RandomState(4)
    specs = [(rng.randint(0, 64, n).astype(np.int32), m, tmp, k)
             for n, m, tmp, k in [(5, 8, 0.8, 0), (9, 6, 0.0, 0),
                                  (3, 10, 1.1, 8)]]

    def run(**kw):
        eng = Engine(tcfg, tp, max_slots=2, max_seq_len=48,
                     cache_dtype=torch.int8, seed=5, device="cpu", **kw)
        out = [c.new_tokens for c in eng.run(
            [Request(prompt=p.copy(), max_new_tokens=m, temperature=tmp,
                     top_k=k) for p, m, tmp, k in specs])]
        return eng, out

    eng, first = run(paged=True, page_size=16)
    _, again = run(paged=True, page_size=16)
    _, slot = run()
    for a, b, s, (_, m, _, _) in zip(first, again, slot, specs):
        assert len(a) == m and ((a >= 0) & (a < tcfg.vocab_size)).all()
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, s)
    _assert_drained(eng)


@pytest.mark.parametrize("paged", [False, True])
def test_split_route_same_greedy_tokens(monkeypatch, paged):
    """FLASH_FUSED_APPEND=False (append, then flash decode: K10 + K11 in
    slot mode, K14 + K15 over the pool) emits the fused route's greedy
    tokens (int8 cache, bf16 scales)."""
    _, _, tcfg, tp = _models("llama", seed=6)
    specs = _specs()
    kw = dict(cache_dtype=torch.int8, device="cpu", **GEOMETRY)
    if paged:
        kw.update(paged=True, page_size=16)
    out = {}
    for fused in (True, False):
        monkeypatch.setattr(tattn, "FLASH_FUSED_APPEND", fused)
        out[fused] = _run(Engine(tcfg, tp, **kw), Request, specs)
    for a, b in zip(out[True], out[False]):
        np.testing.assert_array_equal(a, b)
