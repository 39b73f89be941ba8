"""The decode loop and perplexity of the port (``models/eval.py``,
``models/data.py``) against the JAX package's on tiny f32 models built
by the JAX package and carried across with ``params_from_numpy`` (mirrors
tests/test_models.py:154 and tests/test_quality.py:94). On the CPU the
decode loop's step body (:class:`DecodeGraph`) runs eagerly over its
buffers; on the card the same body is replayed as a CUDA graph
(tests/test_torch_cuda.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sleekit_tpu.models import data as jdata
from sleekit_tpu.models import eval as jeval
from sleekit_tpu.models import transformer as jtr
from sleekit_tpu.models.zoo import tiny_test as j_tiny
from sleekit_tpu_torch import kernels
from sleekit_tpu_torch.convert import params_from_numpy
from sleekit_tpu_torch.models import data as tdata
from sleekit_tpu_torch.models import eval as teval
from sleekit_tpu_torch.models import transformer as ttr
from sleekit_tpu_torch.models.zoo import tiny_test
from sleekit_tpu_torch.ops.dequant_matmul import K1
from sleekit_tpu_torch.serve.engine import Engine

from tests._torch_port_util import f32, to_numpy_tree
from tests.test_torch_model import FAMILIES, _models

# f32 on both sides: the two sum the same products in other orders, so
# the NLLs differ by a few f32 steps and the perplexity, exp of their
# mean, by about as much relatively: 1e-5 leaves two orders of margin.
PPL_RTOL = 1e-5


def _dense_models(seed=0):
    jcfg = j_tiny()
    jp = jtr.init_params(jcfg, jax.random.PRNGKey(seed))
    tcfg = tiny_test()
    return jcfg, jp, tcfg, params_from_numpy(tcfg, to_numpy_tree(jp),
                                             device="cpu")


def _windows(vocab, seq_len=16, n=96, seed=3):
    stream = tdata.synthetic_stream(vocab, n, seed)
    return list(teval.chunk_tokens(stream, seq_len, batch_size=2))


@pytest.mark.parametrize("which", ["perplexity", "decode_perplexity"])
@pytest.mark.parametrize("model", ["dense", "packed"])
def test_perplexity_matches_jax(model, which):
    """perplexity (full forward) and decode_perplexity (teacher-forced
    decode steps through the runner, f32 cache and scales: JAX's
    defaults) equal the JAX package's within PPL_RTOL, dense and packed
    int4 'pair' (int8 head); 6 windows of 16 in batches of 2 and 1."""
    if model == "dense":
        jcfg, jp, tcfg, tp = _dense_models()
    else:
        jcfg, jp, tcfg, tp = _models("opt", seed=4)
    batches = _windows(tcfg.vocab_size) + _windows(tcfg.vocab_size, n=16)
    want = getattr(jeval, which)(jcfg, jp, [jnp.asarray(b)
                                            for b in batches])
    got = getattr(teval, which)(tcfg, tp, batches, device="cpu")
    np.testing.assert_allclose(got, want, rtol=PPL_RTOL)
    assert 1.0 < got < 10 * tcfg.vocab_size


def test_forward_and_decode_perplexity_agree():
    """The port's two routes score the same packed model alike (the JAX
    package pins the same pair within 0.01 ppl, tests/test_quality.py)."""
    _, _, tcfg, tp = _models("llama", seed=2)
    batches = _windows(tcfg.vocab_size)
    fwd = teval.perplexity(tcfg, tp, batches, device="cpu")
    dec = teval.decode_perplexity(tcfg, tp, batches, device="cpu")
    np.testing.assert_allclose(dec, fwd, rtol=PPL_RTOL)


def test_chunk_tokens_and_streams_match_jax():
    """synthetic_stream, chunk_tokens and calibration_batches give the JAX
    package's arrays (the stream comes from np.random.default_rng on
    both sides)."""
    for vocab, n, seed in ((256, 1000, 0), (50272, 512, 7)):
        a = tdata.synthetic_stream(vocab, n, seed)
        b = jdata.synthetic_stream(vocab, n, seed)
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype == np.int32
    stream = tdata.synthetic_stream(256, 101, 1)
    for seq, batch in ((16, 2), (10, 3), (101, 1)):
        got = list(teval.chunk_tokens(stream, seq, batch))
        want = list(jeval.chunk_tokens(stream, seq, batch))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
            assert g.dtype == np.int32
    for samples, seq, batch in ((5, 16, 2), (4, 64, 2)):
        got = tdata.calibration_batches(stream, samples, seq, batch)
        want = jdata.calibration_batches(stream, samples, seq, batch)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def _prefilled(jcfg, jp, tcfg, tp, prompt, max_len):
    """Both packages' caches after prefilling ``prompt``, and the first
    greedy token (equal on both sides, asserted)."""
    jc = jtr.init_kv_cache(jcfg, prompt.shape[0], max_len)
    jl, jc = jtr.prefill(jcfg, jp, jnp.asarray(prompt), jc)
    tc = ttr.init_kv_cache(tcfg, prompt.shape[0], max_len, device="cpu")
    tl, tc = ttr.prefill(tcfg, tp, torch.from_numpy(prompt).long(), tc)
    first = np.asarray(jnp.argmax(jl[:, -1], axis=-1)).astype(np.int32)
    np.testing.assert_array_equal(f32(tl[:, -1]).argmax(-1), first)
    return jc, tc, first


@pytest.mark.parametrize("family", list(FAMILIES))
def test_decode_graph_body_matches_jax_decode_scan(family):
    """The runner's step body, run eagerly on the CPU for 8 steps, gives
    JAX's decode_scan greedy tokens and those of a Python loop of
    decode_step + argmax, and leaves the same cache as that loop."""
    jcfg, jp, tcfg, tp = _models(family, seed=9)
    prompt = np.random.RandomState(1).randint(0, 256, (2, 6)).astype(
        np.int32)
    steps, t = 8, prompt.shape[1]
    jc, tc, first = _prefilled(jcfg, jp, tcfg, tp, prompt, 32)
    want, *_ = jeval.decode_scan(jcfg, jp, jc, jnp.asarray(first),
                                 jnp.int32(t), steps)
    loop_cache = {k: v.clone() for k, v in tc.items()}
    run = teval.DecodeGraph(tcfg, tp, 2, steps, device="cpu")
    assert not run.graphs
    run.last.copy_(torch.from_numpy(first))
    run.pos.fill_(t)
    run.run(tc, steps)
    np.testing.assert_array_equal(run.tokens.numpy(), np.asarray(want))
    last, loop = torch.from_numpy(first), []
    for i in range(steps):
        logits, _ = ttr.decode_step(tcfg, tp, last[:, None].long(),
                                    loop_cache, t + i)
        last = torch.argmax(logits, dim=-1).to(torch.int32)
        loop.append(last)
    assert torch.equal(run.tokens, torch.stack(loop, dim=1))
    assert torch.equal(run.pos, torch.full((2,), t + steps,
                                           dtype=torch.int32))
    for k in tc:
        assert torch.equal(tc[k], loop_cache[k]), k
    toks, _, last, pos = teval.decode_scan(
        tcfg, tp, {k: v.clone() for k, v in loop_cache.items()},
        run.last.clone(), t + steps, 3)
    assert toks.shape == (2, 3) and pos == t + steps + 3


@pytest.mark.parametrize("family", list(FAMILIES))
@pytest.mark.parametrize("paged", [False, True])
def test_vector_pos_equals_int_pos(family, paged):
    """A (B,) int32 position holding one value in every row gives the
    logits and the cache of that int position, bit for bit, on the
    kernels' plain route over an int8 cache (bf16 scales), slot and
    paged: the graph route always passes the vector."""
    _, _, tcfg, tp = _models(family, seed=1)
    B, S, PS = 3, 32, 8
    rng = np.random.RandomState(2)
    if paged:
        cache = ttr.init_paged_kv_cache(tcfg, 2 * B * S // PS + 1, PS, B,
                                        S // PS, torch.int8, device="cpu")
        pages = rng.permutation(np.arange(1, cache["k"].shape[1]))
        cache["page_table"].copy_(torch.from_numpy(
            pages[:B * S // PS].reshape(B, S // PS).astype(np.int32)))
    else:
        cache = ttr.init_kv_cache(tcfg, B, S, torch.int8, device="cpu")
    for key in ("k", "v"):
        cache[key].copy_(torch.from_numpy(
            rng.randint(-127, 128, cache[key].shape).astype(np.int8)))
        cache[key + "_scale"].copy_(torch.from_numpy(
            rng.rand(*cache[key + "_scale"].shape).astype(np.float32)
            * 0.02))
    tok = torch.from_numpy(rng.randint(0, 256, (B, 1)))
    c_int = {k: v.clone() for k, v in cache.items()}
    c_vec = {k: v.clone() for k, v in cache.items()}
    a, _ = ttr.decode_step(tcfg, tp, tok, c_int, 13, use_kernel=True)
    b, _ = ttr.decode_step(tcfg, tp, tok, c_vec,
                           torch.full((B,), 13, dtype=torch.int32),
                           use_kernel=True)
    assert torch.equal(a, b)
    for k in cache:
        assert torch.equal(c_int[k], c_vec[k]), k


def test_graphs_need_cuda():
    """graphs=True on the CPU raises: no silent eager route."""
    _, _, tcfg, tp = _models("opt")
    with pytest.raises(ValueError, match="graphs=True needs a CUDA"):
        Engine(tcfg, tp, device="cpu", graphs=True)
    with pytest.raises(ValueError, match="graphs=True needs a CUDA"):
        teval.DecodeGraph(tcfg, tp, 2, 4, device="cpu", graphs=True)
    with pytest.raises(ValueError, match="mode"):
        teval.DecodeGraph(tcfg, tp, 2, 4, mode="beam", device="cpu")
    eng = Engine(tcfg, tp, device="cpu")
    assert not eng.graphs


def test_decode_graph_steps_bounds():
    """A call takes 1 to max_steps steps; the token buffer is written at
    the call's step index, from 0 at every call."""
    _, _, tcfg, tp = _models("opt", seed=4)
    cache = ttr.init_kv_cache(tcfg, 2, 32, device="cpu")
    run = teval.DecodeGraph(tcfg, tp, 2, 3, device="cpu")
    for bad in (0, 4):
        with pytest.raises(ValueError, match="steps"):
            run.run(cache, bad)
    run.run(cache, 3)
    first = run.tokens.clone()
    run.last.copy_(first[:, 2])
    run.run(cache, 1)
    assert torch.equal(run.tokens[:, 1:], first[:, 1:])
    assert torch.equal(run.pos, torch.full((2,), 4, dtype=torch.int32))


def test_decode_graph_sampled_reproducible():
    """Sampled and top-k/p runners draw from their generator: the same
    seed gives the same tokens; greedy rows (temperature 0) take the
    argmax, as the greedy runner does."""
    _, _, tcfg, tp = _models("bloom", seed=3)

    def run(mode, seed, temps):
        cache = ttr.init_kv_cache(tcfg, 3, 32, device="cpu")
        g = torch.Generator().manual_seed(seed)
        r = teval.DecodeGraph(tcfg, tp, 3, 6, mode, g, device="cpu")
        r.last.copy_(torch.tensor([5, 9, 200], dtype=torch.int32))
        r.temps.copy_(torch.tensor(temps))
        r.top_ks.fill_(20)
        r.top_ps.fill_(0.9)
        r.run(cache, 6)
        return r.tokens.clone()

    for mode in ("sample", "topkp"):
        a = run(mode, 11, [0.9, 0.0, 1.3])
        assert torch.equal(a, run(mode, 11, [0.9, 0.0, 1.3]))
        greedy = run("greedy", 0, [0.0, 0.0, 0.0])
        assert torch.equal(a[1], greedy[1])


def test_captured_launches_count_at_replay():
    """Calls made while a graph is captured leave the counts and come back
    once a replay (the CPU runs no kernel: the count is moved by hand)."""
    start = K1.launches
    try:
        with kernels.captured_launches() as calls:
            K1.launches += 3
        assert K1.launches == start and calls == {K1: 3}
        kernels.add_launches(calls, 4)
        assert K1.launches == start + 12
    finally:
        K1.launches = start
