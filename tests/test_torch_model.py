"""The serving slice as a whole: tiny OPT / BLOOM (ALiBi, gelu, embed_ln) /
Llama (RoPE, GQA, silu_glu, rmsnorm) packed int4 'pair' models built by
the JAX package, carried across with ``params_from_numpy``, served by both
packages on the same inputs (mirrors tests/test_serve.py:23,36,72 and
tests/test_fusion.py)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sleekit_tpu.models import transformer as jtr
from sleekit_tpu.models.fake_quant import random_packed_params as j_random
from sleekit_tpu.models.quantize import pack_lm_head as j_pack_head
from sleekit_tpu.models.zoo import tiny_test as j_tiny
from sleekit_tpu.serve.engine import Engine as JEngine, Request as JRequest
from sleekit_tpu_torch.convert import params_from_numpy
from sleekit_tpu_torch.models.fake_quant import random_packed_params
from sleekit_tpu_torch.models import transformer as ttr
from sleekit_tpu_torch.models.eval import sample_tokens, sample_tokens_topkp
from sleekit_tpu_torch.models.quantize import pack_lm_head
from sleekit_tpu_torch.models.zoo import tiny_test
from sleekit_tpu_torch.serve.engine import Engine, Request

from tests._torch_port_util import bf16_close, f32, to_numpy_tree

FAMILIES = {
    "opt": dict(),
    "bloom": dict(activation="gelu", positional="alibi", embed_ln=True),
    "llama": dict(activation="silu_glu", norm="rmsnorm", positional="rope",
                  n_kv_heads=2, tie_embeddings=False),
}


def _models(family, dtype="f32", stacked=False, seed=0, **kw):
    """(JAX cfg, JAX params, port cfg, port params) of one packed model."""
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if dtype == "bf16"
                else (jnp.float32, torch.float32))
    geo = dict(FAMILIES[family], **kw)
    jcfg = j_tiny(dtype=jdt, scan_layers=stacked, **geo)
    tcfg = tiny_test(dtype=tdt, **geo)
    # scan_layers: the JAX package returns the layers stacked.
    jp, _ = j_random(jcfg, jax.random.PRNGKey(seed), fuse_qkv=True,
                     layout="pair")
    jp = j_pack_head(jcfg, jp)
    tp = params_from_numpy(tcfg, to_numpy_tree(jp), device="cpu")
    return jcfg, jp, tcfg, tp


def _prefill_and_decode_jax(cfg, params, tokens, pos, nxt):
    cache = jtr.init_kv_cache(cfg, tokens.shape[0], 64)
    lp, cache = jtr.prefill(cfg, params, jnp.asarray(tokens), cache)
    ld, _ = jtr.decode_step(cfg, params, jnp.asarray(nxt), cache,
                            jnp.asarray(pos))
    return np.asarray(lp, np.float32), np.asarray(ld, np.float32)


def _prefill_and_decode_port(cfg, params, tokens, pos, nxt, use_kernel=None,
                             cache_dtype=torch.float32, S=64):
    cache = ttr.init_kv_cache(cfg, tokens.shape[0], S, cache_dtype,
                              device="cpu")
    lp, cache = ttr.prefill(cfg, params, torch.from_numpy(tokens), cache,
                            use_kernel=use_kernel)
    ld, _ = ttr.decode_step(cfg, params, torch.from_numpy(nxt), cache,
                            torch.from_numpy(pos), use_kernel=use_kernel)
    return f32(lp), f32(ld)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_prefill_decode_logits_match_jax_f32(family):
    """prefill and ragged decode_step logits == the JAX package's, f32,
    within 1e-4 (f32 sums in another order through two layers)."""
    jcfg, jp, tcfg, tp = _models(family)
    rng = np.random.RandomState(1)
    tokens = rng.randint(0, 256, (2, 11)).astype(np.int32)
    pos = np.asarray([11, 7], np.int32)
    nxt = rng.randint(0, 256, (2, 1)).astype(np.int32)
    want = _prefill_and_decode_jax(jcfg, jp, tokens, pos, nxt)
    got = _prefill_and_decode_port(tcfg, tp, tokens, pos, nxt)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("family", ["opt", "llama"])
def test_prefill_int8_cache_matches_jax(family, monkeypatch):
    """The port's prefill writes the JAX package's int8 cache (f32 scale
    planes) on a tiny f32 model (MHA, and GQA with RoPE). The two compute
    K/V with f32 sums in another order, so a value can differ by an ulp:
    its scale then by about 1e-7 relative (rtol 1e-6 holds it), and its
    int8 code by at most 1, and only where x / scale sits on a rounding
    tie (within 1e-4: an ulp of K/V, or of the scale, moves x / scale by
    at most 127 * 2^-23 * 2, 3e-5)."""
    jcfg, jp, tcfg, tp = _models(family)
    tokens = np.random.RandomState(4).randint(0, 256, (2, 13)).astype(
        np.int32)
    jcache = jtr.init_kv_cache(jcfg, 2, 64, jnp.int8,
                               scale_dtype=jnp.float32)
    _, jcache = jtr.prefill(jcfg, jp, jnp.asarray(tokens), jcache)
    seen = []
    write = ttr.kv_prefill_write_plain

    def record(k, v, *args):
        seen.append((k.float().clone(), v.float().clone()))
        return write(k, v, *args)
    monkeypatch.setattr(ttr, "kv_prefill_write_plain", record)
    tcache = ttr.init_kv_cache(tcfg, 2, 64, torch.int8,
                               scale_dtype=torch.float32, device="cpu")
    ttr.prefill(tcfg, tp, torch.from_numpy(tokens), tcache)
    assert len(seen) == tcfg.n_layers
    for i, (entry, kv) in enumerate(zip(jcache, seen)):
        for name, x in zip("kv", kv):
            codes = tcache[name][i].numpy().astype(np.int32)
            want = np.asarray(entry[name]).astype(np.int32)
            scale = tcache[f"{name}_scale"][i].numpy()
            np.testing.assert_allclose(
                scale, np.asarray(entry[f"{name}_scale"]), rtol=1e-6)
            diff = np.abs(codes - want)
            assert diff.max() <= 1, (i, name)
            b, h, s, dd = np.nonzero(diff)
            ratio = x.numpy()[b, s, h, dd] / scale[b, h, s]
            assert (np.abs(ratio - np.floor(ratio) - 0.5) <= 1e-4).all()


def test_stacked_jax_params_convert():
    """params_from_numpy takes the stacked (scan_layers) layout too: the
    packed words stay one (L, kw, N) tensor, each layer a view of it, and
    the logits equal those of the per-layer tree."""
    jcfg, jp, tcfg, tp = _models("opt", stacked=True)
    _, jp_list, _, tp_list = _models("opt")
    qkv = [layer["attn"]["qkv"].packed for layer in tp["layers"]]
    assert qkv[1].data_ptr() == qkv[0].data_ptr() + qkv[0].nbytes
    tokens = np.random.RandomState(2).randint(0, 256, (2, 9)).astype(np.int32)
    a = ttr.forward(tcfg, tp, torch.from_numpy(tokens))
    b = ttr.forward(tcfg, tp_list, torch.from_numpy(tokens))
    np.testing.assert_array_equal(f32(a), f32(b))


@pytest.mark.parametrize("family", list(FAMILIES))
def test_engine_greedy_tokens_match_jax_engine(family):
    """The port's Engine and the JAX package's Engine emit IDENTICAL greedy
    tokens on a packed int4 pair model with an int8 head and an int8 KV
    cache (bf16 scales), f32 activations, for ragged requests that
    outnumber the slots (continuous batching + fused steps)."""
    jcfg, jp, tcfg, tp = _models(family, seed=3)
    rng = np.random.RandomState(5)
    specs = [(int(rng.randint(3, 20)), int(rng.randint(2, 11)))
             for _ in range(4)]
    prompts = [rng.randint(0, 256, (n,)).astype(np.int32) for n, _ in specs]
    jeng = JEngine(jcfg, jp, max_slots=2, max_seq_len=64,
                   cache_dtype=jnp.int8)
    want = jeng.run([JRequest(prompt=p, max_new_tokens=m)
                     for p, (_, m) in zip(prompts, specs)])
    teng = Engine(tcfg, tp, max_slots=2, max_seq_len=64,
                  cache_dtype=torch.int8, device="cpu")
    got = teng.run([Request(prompt=p, max_new_tokens=m)
                    for p, (_, m) in zip(prompts, specs)])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.tokens, w.tokens)
        assert g.finish_reason == w.finish_reason == "length"


@pytest.mark.parametrize("family", list(FAMILIES))
def test_kernel_path_bf16_matches_jax(family):
    """bf16 model through the port's kernel path (K1-K4 plain versions on
    the CPU; the 256-token prompt routes prefill attention to K4) agrees
    with the JAX package's bf16 logits within the bf16 tolerance (rtol
    2^-6, atol 1e-2*max|ref|)."""
    jcfg, jp, tcfg, tp = _models(family, dtype="bf16", max_seq_len=512)
    rng = np.random.RandomState(7)
    tokens = rng.randint(0, 256, (2, 256)).astype(np.int32)
    pos = np.asarray([256, 256], np.int32)
    nxt = rng.randint(0, 256, (2, 1)).astype(np.int32)
    cache = jtr.init_kv_cache(jcfg, 2, 512, jnp.int8)
    lp, cache = jtr.prefill(jcfg, jp, jnp.asarray(tokens), cache)
    ld, _ = jtr.decode_step(jcfg, jp, jnp.asarray(nxt), cache,
                            jnp.asarray(pos))
    got = _prefill_and_decode_port(tcfg, tp, tokens, pos, nxt,
                                   use_kernel=True, cache_dtype=torch.int8,
                                   S=512)
    bf16_close(got[0], lp, "prefill")
    bf16_close(got[1], ld, "decode")


def test_pack_lm_head_matches_jax():
    """pack_lm_head quantizes the tied embedding to the same int8 words and
    scales as the JAX package; padded vocab columns have scale 0."""
    jcfg = j_tiny(vocab_size=100)
    jp = jtr.init_params(jcfg, jax.random.PRNGKey(0))
    tcfg = tiny_test(vocab_size=100)
    tp = params_from_numpy(tcfg, to_numpy_tree(jp), device="cpu")
    want = j_pack_head(jcfg, jp)["lm_head"]
    got = pack_lm_head(tcfg, tp)["lm_head"]
    assert got.out_features == want.out_features == 1024
    np.testing.assert_array_equal(got.packed.numpy(), np.asarray(want.packed))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    assert (got.scale[100:] == 0).all()
    logits = ttr.forward(tcfg, pack_lm_head(tcfg, tp),
                         torch.zeros((1, 3), dtype=torch.int64))
    assert logits.shape == (1, 3, 100)


def _tiny_port_model(seed=0):
    tcfg = tiny_test()
    params, _ = random_packed_params(tcfg, seed, fuse_qkv=True, device="cpu")
    return tcfg, pack_lm_head(tcfg, params)


def test_engine_sampled_reproducible_and_eos():
    """Sampling draws from the Engine's torch.Generator: the same seed gives
    the same tokens, fused or not; greedy EOS stops after that token."""
    tcfg, tp = _tiny_port_model()
    prompt = np.random.RandomState(4).randint(0, 256, (5,)).astype(np.int32)
    outs = []
    for fused in (8, 1, 8):
        eng = Engine(tcfg, tp, max_slots=1, max_seq_len=64, seed=42,
                     fused_steps=fused, device="cpu")
        [c] = eng.run([Request(prompt=prompt, max_new_tokens=6,
                               temperature=0.9, top_k=20, top_p=0.9)])
        outs.append(c.tokens)
    np.testing.assert_array_equal(outs[0], outs[1])
    np.testing.assert_array_equal(outs[0], outs[2])
    eng = Engine(tcfg, tp, max_slots=1, max_seq_len=64, device="cpu")
    [probe] = eng.run([Request(prompt=prompt, max_new_tokens=1)])
    eos = int(probe.new_tokens[0])
    [c] = eng.run([Request(prompt=prompt, max_new_tokens=10, eos_id=eos)])
    assert c.finish_reason == "eos" and c.new_tokens.tolist() == [eos]


def test_sample_tokens_support():
    """Greedy slots take the argmax; top_k=1 and a tiny top_p leave only
    the argmax; sampled tokens stay inside the top-k set."""
    g = torch.Generator().manual_seed(0)
    logits = torch.randn(4, 50, generator=g)
    best = logits.argmax(-1).to(torch.int32)
    zeros = torch.zeros(4)
    ones = torch.ones(4)
    assert torch.equal(sample_tokens(logits, zeros, g), best)
    k1 = sample_tokens_topkp(logits, ones, torch.ones(4, dtype=torch.int64),
                             ones, g)
    assert torch.equal(k1, best)
    p0 = sample_tokens_topkp(logits, ones, torch.zeros(4, dtype=torch.int64),
                             torch.full((4,), 1e-6), g)
    assert torch.equal(p0, best)
    top5 = logits.topk(5, dim=-1).indices
    for _ in range(20):
        s = sample_tokens_topkp(logits, ones,
                                torch.full((4,), 5, dtype=torch.int64),
                                ones, g)
        assert (top5 == s[:, None].long()).any(dim=-1).all()


@pytest.mark.parametrize("family", ["opt", "llama"])
def test_generate_matches_jax(family):
    """generate and generate_fused give the JAX package's greedy tokens
    (f32, packed int4 weights, f32 cache)."""
    from sleekit_tpu.models.eval import generate as j_generate
    from sleekit_tpu_torch.models.eval import generate, generate_fused

    jcfg, jp, tcfg, tp = _models(family, seed=6)
    prompt = np.random.RandomState(8).randint(0, 256, (2, 7)).astype(np.int32)
    want = np.asarray(j_generate(jcfg, jp, jnp.asarray(prompt), 6))
    for fn in (generate, generate_fused):
        got = fn(tcfg, tp, torch.from_numpy(prompt).long(), 6)
        np.testing.assert_array_equal(got.numpy(), want)


def test_zoo_configs_match_jax():
    """Every zoo config has the JAX package's geometry, field by field."""
    import dataclasses as dc
    from sleekit_tpu.models import zoo as jzoo
    from sleekit_tpu_torch.models import zoo as tzoo

    assert set(tzoo.ZOO) == set(jzoo.ZOO)
    for name in jzoo.ZOO:
        j, p = jzoo.get_config(name), tzoo.get_config(name)
        for f in dc.fields(p):
            if f.name != "dtype":
                assert getattr(p, f.name) == getattr(j, f.name), (name, f.name)
