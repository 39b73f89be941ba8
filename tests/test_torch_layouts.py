"""The slice of the int3 ('pair3x', 'pair3'), NF4 ('plane') and int4
'plane' configurations as a whole: tiny OPT / Llama models with d_model
512 and d_ff 1024 (so that 'pair3x' really is 'pair3x': every K is a
multiple of 512) built by the JAX package, carried across with
``params_from_numpy`` and served by both packages on the same inputs
(mirrors tests/test_ops.py:416,597 and tests/test_serve.py:23)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sleekit_tpu.codebooks import Codebook as JCodebook
from sleekit_tpu.codebooks import UniformCodebook as JUniform
from sleekit_tpu.models import transformer as jtr
from sleekit_tpu.models.fake_quant import random_packed_params as j_random
from sleekit_tpu.models.quantize import pack_lm_head as j_pack_head
from sleekit_tpu.models.zoo import tiny_test as j_tiny
from sleekit_tpu.serve.engine import Engine as JEngine, Request as JRequest
from sleekit_tpu_torch.convert import params_from_numpy
from sleekit_tpu_torch.models import transformer as ttr
from sleekit_tpu_torch.models.zoo import tiny_test
from sleekit_tpu_torch.ops.pack import PackedLinear
from sleekit_tpu_torch.serve.engine import Engine, Request

from tests._torch_port_util import bf16_close, f32, to_numpy_tree

FAMILIES = {
    "opt": dict(),
    "llama": dict(activation="silu_glu", norm="rmsnorm", positional="rope",
                  n_kv_heads=2, tie_embeddings=False),
}
# (layout, codebook) of each configuration: int3, int3p, nf4, int4 plane.
CONFIGS = {
    "pair3x": ("pair3x", lambda: JUniform(8, -1.0, 1.0)),
    "pair3": ("pair3", lambda: JUniform(8, -1.0, 1.0)),
    "nf4": ("plane", JCodebook.nf4),
    "plane4": ("plane", lambda: JUniform(16, -1.0, 1.0)),
}
# Each configuration once, both families covered.
CASES = [("opt", "pair3x"), ("llama", "pair3"), ("opt", "nf4"),
         ("llama", "plane4")]


def _models(family, config, dtype="f32", seed=0, **kw):
    """(JAX cfg, JAX params, port cfg, port params) of one packed model
    with an int8 head."""
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if dtype == "bf16"
                else (jnp.float32, torch.float32))
    geo = dict(FAMILIES[family], d_model=512, d_ff=1024, **kw)
    jcfg = j_tiny(dtype=jdt, **geo)
    tcfg = tiny_test(dtype=tdt, **geo)
    layout, codebook = CONFIGS[config]
    jp, _ = j_random(jcfg, jax.random.PRNGKey(seed), codebook(),
                     fuse_qkv=True, layout=layout)
    jp = j_pack_head(jcfg, jp)
    tp = params_from_numpy(tcfg, to_numpy_tree(jp), device="cpu")
    return jcfg, jp, tcfg, tp


def _layouts(params):
    return {p.layout for layer in params["layers"] for part in layer.values()
            if isinstance(part, dict) for p in part.values()
            if isinstance(p, PackedLinear)}


@pytest.mark.parametrize("family,config", CASES)
def test_kernel_path_bf16_matches_jax(family, config):
    """bf16 prefill and ragged decode logits through the port's kernel path
    (K6-K9 plain versions on the CPU) == the JAX package's within the bf16
    tolerance (rtol 2^-6, atol 1e-2*max|ref|)."""
    jcfg, jp, tcfg, tp = _models(family, config, dtype="bf16", n_layers=1)
    assert _layouts(tp) == {CONFIGS[config][0]}
    rng = np.random.RandomState(7)
    tokens = rng.randint(0, 256, (2, 24)).astype(np.int32)
    pos = np.asarray([24, 17], np.int32)
    nxt = rng.randint(0, 256, (2, 1)).astype(np.int32)
    cache = jtr.init_kv_cache(jcfg, 2, 64, jnp.int8)
    lp, cache = jtr.prefill(jcfg, jp, jnp.asarray(tokens), cache)
    ld, _ = jtr.decode_step(jcfg, jp, jnp.asarray(nxt), cache,
                            jnp.asarray(pos))
    tcache = ttr.init_kv_cache(tcfg, 2, 64, torch.int8, device="cpu")
    gp, tcache = ttr.prefill(tcfg, tp, torch.from_numpy(tokens), tcache,
                             use_kernel=True)
    gd, _ = ttr.decode_step(tcfg, tp, torch.from_numpy(nxt), tcache,
                            torch.from_numpy(pos), use_kernel=True)
    bf16_close(gp, np.asarray(lp, np.float32), "prefill")
    bf16_close(gd, np.asarray(ld, np.float32), "decode")


@pytest.mark.parametrize("family,config", CASES)
def test_engine_greedy_tokens_match_jax_engine(family, config):
    """The port's Engine and the JAX package's Engine emit IDENTICAL greedy
    tokens in each configuration (f32 activations, int8 head, int8 KV
    cache), for ragged requests that outnumber the slots."""
    jcfg, jp, tcfg, tp = _models(family, config, seed=3)
    rng = np.random.RandomState(5)
    specs = [(int(rng.randint(3, 20)), int(rng.randint(2, 9)))
             for _ in range(3)]
    prompts = [rng.randint(0, 256, (n,)).astype(np.int32) for n, _ in specs]
    want = JEngine(jcfg, jp, max_slots=2, max_seq_len=64,
                   cache_dtype=jnp.int8).run(
        [JRequest(prompt=p, max_new_tokens=m)
         for p, (_, m) in zip(prompts, specs)])
    got = Engine(tcfg, tp, max_slots=2, max_seq_len=64,
                 cache_dtype=torch.int8, device="cpu").run(
        [Request(prompt=p, max_new_tokens=m)
         for p, (_, m) in zip(prompts, specs)])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.tokens, w.tokens)


def test_port_random_params_serve_each_layout():
    """The port's own random_packed_params builds every configuration
    (pair3x falling back to pair3 where K % 512 != 0, a real pack for a
    codebook that is not a power of two) and its forward is finite."""
    from sleekit_tpu_torch.codebooks import Codebook, UniformCodebook
    from sleekit_tpu_torch.models.fake_quant import random_packed_params

    tokens = torch.from_numpy(
        np.random.RandomState(1).randint(0, 256, (1, 9)))
    for layout, cb, d, want in (
            ("pair3x", UniformCodebook(8, -1.0, 1.0), 512, {"pair3x"}),
            # K 256 (qkv, o, fc1) falls back; fc2's K 512 stays pair3x
            ("pair3x", UniformCodebook(8, -1.0, 1.0), 256,
             {"pair3", "pair3x"}),
            ("plane", Codebook.nf4(), 64, {"plane"}),
            ("plane", Codebook.create([-1.0, 0.1, 1.0]), 64, {"plane"})):
        cfg = tiny_test(d_model=d, d_ff=2 * d, dtype=torch.bfloat16)
        params, _ = random_packed_params(cfg, 0, codebook=cb, fuse_qkv=True,
                                         layout=layout, device="cpu")
        assert _layouts(params) == want
        logits = ttr.forward(cfg, params, tokens, use_kernel=True)
        assert logits.shape == (1, 9, 256)
        assert np.isfinite(f32(logits)).all()
