"""``Engine(mesh=...)`` in the port against the JAX package's (mirrors
tests/test_engine_tp.py:38,64): two gloo ranks serve a tiny packed model
built by the JAX package in lockstep, and emit the port's single-device
Engine's tokens and the JAX TP Engine's (``make_mesh(data=1, model=2)``
over conftest's virtual CPU devices), greedy and sampled; an skq2
checkpoint the JAX package wrote from a split tree serves in the port.
JAX's TP prefill gets the head-width scale fix described in
tests/test_torch_tp_decode.py."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sleekit_tpu.codebooks import UniformCodebook as JUniform
from sleekit_tpu.models.fake_quant import random_packed_params as j_random
from sleekit_tpu.models.quantize import pack_lm_head as j_pack_head
from sleekit_tpu.models.zoo import tiny_test as j_tiny
from sleekit_tpu.parallel import mesh as jmesh
from sleekit_tpu.serve.checkpoint import save_packed_params as j_save
from sleekit_tpu.serve.engine import Engine as JEngine, Request as JRequest
from sleekit_tpu_torch.convert import params_from_numpy
from sleekit_tpu_torch.models.zoo import tiny_test
from sleekit_tpu_torch.serve.checkpoint import load_packed_params
from sleekit_tpu_torch.serve.engine import Engine, Request

from tests._torch_port_util import to_numpy_tree
from tests._torch_tp_ranks import Ranks
from tests.test_torch_model import FAMILIES
from tests.test_torch_tp_decode import jax_head_dim_fix  # noqa: F401

pytestmark = pytest.mark.usefixtures("jax_head_dim_fix")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    with Ranks(2, tmp_path_factory.mktemp("tp_engine")) as r:
        yield r


def _model(family, seed=0):
    """(JAX cfg, JAX params, port cfg, numpy tree): unfused int4 'pair'
    with an int8 head, as tests/test_engine_tp.py builds it."""
    jcfg = j_tiny(**FAMILIES[family])
    jp, _ = j_random(jcfg, jax.random.PRNGKey(seed), JUniform(16, -1.0, 1.0),
                     layout="pair")
    jp = j_pack_head(jcfg, jp)
    return jcfg, jp, tiny_test(**FAMILIES[family]), to_numpy_tree(jp)


def _specs(seed=3, **kw):
    """tests/test_engine_tp.py's request mix, as dicts of ``Request``'s
    fields (``kw`` added to each)."""
    rng = np.random.RandomState(seed)
    return [dict(prompt=rng.randint(0, 256, (n,)).astype(np.int32),
                 max_new_tokens=m, **kw)
            for n, m in ((5, 8), (11, 4), (3, 12), (7, 6), (19, 5))]


def _single(tcfg, tree, specs, **kw):
    engine = Engine(tcfg, params_from_numpy(tcfg, tree, device="cpu"),
                    device="cpu", **kw)
    return [c.new_tokens.tolist() for c in engine.run(
        [Request(**spec) for spec in specs])]


def _tp(ranks, tcfg, params, specs, split=False, **kw):
    """Both ranks' tokens, which must be equal."""
    got = [[t.tolist() for t in r] for r in ranks(
        "engine_tokens", cfg=tcfg, params=params, specs=specs,
        engine_kw=kw, split=split)]
    assert got[0] == got[1]
    return got[0]


@pytest.mark.parametrize("family,cache,paged,jax_tp", [
    ("opt", "f32", False, True), ("opt", "int8", False, False),
    ("bloom", "int8", True, True), ("llama", "int8", False, False)])
def test_engine_tp_matches_single_and_jax(ranks, family, cache, paged,
                                          jax_tp):
    """Greedy continuous batching over two ranks (five requests, four
    slots): the port's single-device Engine's tokens, slot and paged, f32
    and int8 (bf16 scales) caches, and (``jax_tp``; each compiles its own
    programs) the JAX TP Engine's."""
    jcfg, jp, tcfg, tree = _model(family)
    specs = _specs()
    jdt, tdt = ((jnp.int8, torch.int8) if cache == "int8"
                else (jnp.float32, torch.float32))
    kw = dict(max_slots=4, max_seq_len=64, paged=paged, page_size=16)
    want = _single(tcfg, tree, specs, cache_dtype=tdt, **kw)
    assert _tp(ranks, tcfg, tree, specs, cache_dtype=tdt, **kw) == want
    if jax_tp:
        jeng = JEngine(jcfg, jmesh.prepare_params_for_tp(jcfg, jp, 2),
                       cache_dtype=jdt, mesh=jmesh.make_mesh(data=1, model=2),
                       **kw)
        assert [c.new_tokens.tolist() for c in jeng.run(
            [JRequest(**spec) for spec in specs])] == want


@pytest.mark.parametrize("sampling", [{}, dict(top_k=5, top_p=0.9)])
def test_engine_tp_sampled_matches_single(ranks, sampling):
    """Sampled requests (temperature 0.8, one greedy request in the same
    batch; then with top-k and top-p) through the fused steps: every rank
    draws from a generator of the Engine's seed, so the TP Engine emits
    the single-device Engine's tokens, token for token."""
    _, _, tcfg, tree = _model("opt")
    specs = _specs(seed=8, temperature=0.8, **sampling)[:3]
    specs[1]["temperature"] = 0.0
    kw = dict(max_slots=2, max_seq_len=64, fused_steps=4, seed=3)
    assert _tp(ranks, tcfg, tree, specs, **kw) == _single(tcfg, tree, specs,
                                                          **kw)


def test_jax_split_checkpoint_serves_in_the_port(ranks, tmp_path):
    """An skq2 checkpoint that the JAX package wrote from
    ``prepare_params_for_tp(..., 2)``: the port loads its k_splits and
    words, dequantizes each split linear to the unsplit one's matrix, and
    serves it over two ranks with the single-device Engine's tokens."""
    jcfg, jp, tcfg, tree = _model("opt", seed=1)
    j_save(str(tmp_path), jmesh.prepare_params_for_tp(jcfg, jp, 2),
           meta={"model": "tiny"})
    split, _ = load_packed_params(str(tmp_path), cfg=tcfg, device="cpu")
    full = params_from_numpy(tcfg, tree, device="cpu")
    for layer, ref in zip(split["layers"], full["layers"]):
        for grp, name in (("attn", "o"), ("mlp", "fc2"), ("attn", "q")):
            w, r = layer[grp][name], ref[grp][name]
            assert w.k_splits == (1 if name == "q" else 2)
            np.testing.assert_array_equal(w.dequantize().numpy(),
                                          r.dequantize().numpy())
    specs = _specs(seed=4)
    kw = dict(max_slots=4, max_seq_len=64, cache_dtype=torch.int8)
    assert _tp(ranks, tcfg, str(tmp_path), specs, split=True, **kw) == (
        _single(tcfg, tree, specs, **kw))
