"""Tensor-parallel prefill and decode in the port against the JAX
package's (mirrors tests/test_tp_decode.py and tests/test_tp_packed.py:92,
tests/test_parallel.py:131): two gloo ranks, each on its shard of a tiny
packed model built by the JAX package, carried across with
``params_from_numpy``; JAX's ``tp_prefill`` and ``tp_decode_step`` on 2
of conftest's virtual CPU devices (``make_mesh(data=1, model=2)``).

JAX's ``tp_prefill`` attends with its local config's ``head_dim``
(d_model over the LOCAL heads), so its attention scale is 1/sqrt(n*hd),
not the model's: a fault of the reference, which its single-device
``prefill`` does not have. The test gives JAX's ``_attention`` a config
whose head_dim is the head's width there; JAX's decode step and every KV
row need no such help.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sleekit_tpu.codebooks import Codebook as JCodebook
from sleekit_tpu.codebooks import UniformCodebook as JUniform
from sleekit_tpu.models import transformer as jtr
from sleekit_tpu.models import zoo as jzoo
from sleekit_tpu.models.fake_quant import random_packed_params as j_random
from sleekit_tpu.models.quantize import pack_lm_head as j_pack_head
from sleekit_tpu.ops.pack import PackedLinear as JPacked
from sleekit_tpu.parallel import comm_model as jcm
from sleekit_tpu.parallel import mesh as jmesh
from sleekit_tpu.parallel.tp_decode import tp_decode_step as j_tp_decode
from sleekit_tpu.parallel.tp_decode import tp_prefill as j_tp_prefill
from sleekit_tpu_torch.convert import params_from_numpy
from sleekit_tpu_torch.models import transformer as ttr
from sleekit_tpu_torch.models import zoo as tzoo
from sleekit_tpu_torch.parallel import comm_model as tcm

from tests._torch_port_util import to_numpy_tree
from tests._torch_tp_ranks import Ranks, same_on_every_rank
from tests.test_torch_model import FAMILIES

B, T, S, PAGE = 2, 11, 32, 8
TOL = dict(rtol=2e-4, atol=2e-4)

# (family, cache, layout, cache mode, head): every family, f32 and int8
# caches, 'pair' and 'plane' (uniform and NF4), slot and paged, and each
# kind of head (the int8 head and a dense one all-gathered over the vocab,
# a tied one replicated), each in at least one case.
CASES = [("opt", "f32", "pair", "slot", "int8"),
         ("bloom", "int8", "plane-nf4", "slot", "tied"),
         ("llama", "int8", "pair", "paged", "dense"),
         ("opt", "f32", "plane", "paged", "int8")]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    with Ranks(2, tmp_path_factory.mktemp("tp_decode")) as r:
        yield r


@pytest.fixture
def jax_head_dim_fix(monkeypatch):
    """JAX's ``_attention`` with the scale of the head's width (see the
    module's docstring); the identity on a single-device config."""
    attention = jtr._attention

    def fixed(cfg, q, k, v, bias):
        cfg = dataclasses.replace(cfg, d_model=q.shape[-1] * cfg.n_heads)
        return attention(cfg, q, k, v, bias)

    monkeypatch.setattr(jtr, "_attention", fixed)


def _model(family, layout, head, seed):
    """(JAX cfg, JAX params, port cfg, numpy tree): unfused packed params
    with random biases wherever the family has them."""
    jcfg = jzoo.tiny_test(**FAMILIES[family])
    tcfg = tzoo.tiny_test(**FAMILIES[family])
    cb = JCodebook.nf4() if layout == "plane-nf4" else JUniform(16, -1.0, 1.0)
    jp, _ = j_random(jcfg, jax.random.PRNGKey(seed), codebook=cb,
                     layout=layout.split("-")[0])
    if head == "int8":
        jp = j_pack_head(jcfg, jp)
    rng = np.random.RandomState(seed)

    def biased(p):
        if isinstance(p, JPacked) and p.bias is not None:
            return dataclasses.replace(p, bias=jnp.asarray(
                0.05 * rng.randn(p.out_features), jnp.float32))
        return p

    jp = dict(jp, layers=[{**layer, **{grp: {k: biased(v) for k, v in
                                              layer[grp].items()}
                                       for grp in ("attn", "mlp")}}
                          for layer in jp["layers"]])
    assert ("lm_head" in jp) == (head != "tied")
    return jcfg, jp, tcfg, to_numpy_tree(jp)


def _stacked(cache):
    """A JAX per-layer cache list as one stacked numpy dict."""
    return {k: np.stack([np.asarray(e[k]) for e in cache]) for k in cache[0]}


def _pool(slot, seed):
    """The stacked slot cache's rows in a page pool of PAGE-row pages, the
    page table a shuffle of pages 1.. (page 0 the trash page)."""
    pages = S // PAGE
    table = (np.random.RandomState(seed).permutation(B * pages) + 1
             ).reshape(B, pages).astype(np.int32)
    pool = {}
    for key, v in slot.items():
        out = np.zeros((v.shape[0], 1 + B * pages) + v.shape[2:3]
                       + (PAGE,) + v.shape[4:], v.dtype)
        for b in range(B):
            for j in range(pages):
                out[:, table[b, j]] = v[:, b, :, j * PAGE:(j + 1) * PAGE]
        pool[key] = out
    pool["page_table"] = table
    return pool


def _shard_of(full, rank, n=2):
    """Rank ``rank``'s kv-head block (axis 2) of a stacked cache."""
    kv = full.shape[2] // n
    return full[:, :, rank * kv:(rank + 1) * kv]


def _close_cache(got, want, what):
    """KV within 2e-4: f32 rows, and the scales of int8 rows within 1e-5,
    their codes equal."""
    for key, w in want.items():
        g = got[key]
        if key == "page_table":
            np.testing.assert_array_equal(g, w)
        elif w.dtype == np.int8:
            np.testing.assert_array_equal(g, w, err_msg=f"{what} {key}")
        elif key.endswith("scale"):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-7,
                                       err_msg=f"{what} {key}")
        else:
            np.testing.assert_allclose(g, w, **TOL, err_msg=f"{what} {key}")


@pytest.mark.usefixtures("jax_head_dim_fix")
@pytest.mark.parametrize("family,cache,layout,mode,head", CASES)
def test_tp_prefill_and_decode_match_jax(ranks, family, cache, layout, mode,
                                         head):
    """Two ranks' ``tp_prefill`` and ``tp_decode_step``: logits equal on
    both ranks and within 2e-4 of JAX's TP and single-device functions and
    of the port's single-device ones; each rank's KV within 2e-4 of its
    block of JAX's; two all-reduces a layer and one all-gather when there
    is an lm_head, as ``comm_model.decode_step_comm`` counts them."""
    seed = CASES.index((family, cache, layout, mode, head))
    jcfg, jp, tcfg, tree = _model(family, layout, head, seed)
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, 256, (B, T)).astype(np.int32)
    nxt = rng.randint(0, 256, (B, 1)).astype(np.int32)
    pos = np.asarray([T, T - 4], np.int32)
    jdt, tdt = ((jnp.int8, torch.int8) if cache == "int8"
                else (jnp.float32, torch.float32))

    # JAX: TP prefill (2 devices) and single-device prefill, then the TP
    # decode step over the single-device prefill's cache.
    mesh = jmesh.make_mesh(data=1, model=2)
    jtp = jmesh.prepare_params_for_tp(jcfg, jp, 2)

    def fresh():
        return jtr.init_kv_cache(jcfg, B, S, jdt, scale_dtype=jnp.float32)

    with mesh:
        jlp, jpc = jax.jit(lambda p, t, c: j_tp_prefill(
            jcfg, p, t, c, mesh))(jtp, jnp.asarray(tokens), fresh())
    want_prefill = np.asarray(jlp)
    single_prefill, single_cache = jax.jit(
        lambda p, t, c: jtr.prefill(jcfg, p, t, c))(jp, jnp.asarray(tokens),
                                                    fresh())
    decode_cache = _stacked(single_cache)
    if mode == "paged":
        decode_cache = _pool(decode_cache, seed)
        jcache = {k: jnp.asarray(v) for k, v in decode_cache.items()}
    else:
        jcache = [{k: jnp.asarray(v[i]) for k, v in decode_cache.items()}
                  for i in range(jcfg.n_layers)]
    with mesh:
        jld, jdc = jax.jit(lambda p, t, c, q: j_tp_decode(
            jcfg, p, t, c, q, mesh))(jtp, jnp.asarray(nxt), jcache,
                                     jnp.asarray(pos))
    jdc = jdc if mode == "paged" else _stacked(jdc)

    # The port on one device.
    tp_full = params_from_numpy(tcfg, tree, device="cpu")
    own_prefill, _ = ttr.prefill(
        tcfg, tp_full, torch.from_numpy(tokens),
        ttr.init_kv_cache(tcfg, B, S, tdt, torch.float32, device="cpu"))
    own_decode, _ = ttr.decode_step(
        tcfg, tp_full, torch.from_numpy(nxt),
        {k: torch.from_numpy(v.copy()) for k, v in decode_cache.items()},
        torch.from_numpy(pos))

    res = ranks("prefill_decode", cfg=tcfg, params=tree, tokens=tokens,
                cache_dtype=tdt, decode_cache=decode_cache, nxt=nxt, pos=pos)
    got = same_on_every_rank(res, "prefill_logits")
    for want, what in ((want_prefill, "JAX tp_prefill"),
                       (np.asarray(single_prefill), "JAX prefill"),
                       (own_prefill.numpy(), "port prefill")):
        np.testing.assert_allclose(got, want, **TOL, err_msg=what)
    got = same_on_every_rank(res, "decode_logits")
    for want, what in ((np.asarray(jld), "JAX tp_decode_step"),
                       (own_decode.numpy(), "port decode_step")):
        np.testing.assert_allclose(got, want, **TOL, err_msg=what)
    jpc = _stacked(jpc)
    for r, out in enumerate(res):
        _close_cache(out["prefill_cache"],
                     {k: _shard_of(v, r) for k, v in jpc.items()},
                     f"rank {r} prefill")
        _close_cache(out["decode_cache"],
                     {k: v if k == "page_table" else _shard_of(np.asarray(v), r)
                      for k, v in jdc.items()}, f"rank {r} decode")

    gathers = int(head != "tied")
    model = tcm.decode_step_comm(tcfg, B, 2, vocab_gather=bool(gathers))
    for out in res:
        for step in ("prefill_counts", "decode_counts"):
            assert out[step] == {"all_reduce": 2 * tcfg.n_layers,
                                 "all_gather": gathers}
            assert (out[step]["all_reduce"] + out[step]["all_gather"]
                    == model["allreduce_calls"])


@pytest.mark.parametrize("name", sorted(tzoo.ZOO))
def test_comm_model_figures_match_jax(name, monkeypatch):
    """``comm_model``'s counts, wire bytes, weight bytes and step estimate
    equal the JAX package's on each zoo config (its estimate at JAX's
    rates, which the test lends it; the port's own are the H100's)."""
    for port, jax_name in (("HBM_BPS", "HBM_BPS"), ("LINK_BPS", "ICI_BPS"),
                           ("CROSS_HOST_BPS", "DCN_BPS"),
                           ("STEP_OVERHEAD_S", "STEP_OVERHEAD_S"),
                           ("ALLREDUCE_LATENCY_S", "ALLREDUCE_LATENCY_S"),
                           ("CROSS_HOST_LATENCY_S", "DCN_LATENCY_S")):
        monkeypatch.setattr(tcm, port, getattr(jcm, jax_name))
    jcfg, tcfg = jzoo.get_config(name), tzoo.get_config(name)
    renamed = {"link_bytes_per_step": "ici_bytes_per_step"}
    for tp in (2, 4, 8):
        for batch in (1, 8):
            for gather in (True, False):
                want = jcm.decode_step_comm(jcfg, batch, tp,
                                            vocab_gather=gather)
                got = tcm.decode_step_comm(tcfg, batch, tp,
                                           vocab_gather=gather)
                assert {renamed.get(k, k): v for k, v in got.items()} == want
            for cross in (False, True):
                want = jcm.tp_step_estimate(jcfg, batch, tp, cross_host=cross,
                                            kv_bytes_per_step=1e6)
                got = tcm.tp_step_estimate(tcfg, batch, tp, cross_host=cross,
                                           kv_bytes_per_step=1e6)
                assert {renamed.get(k, k): v for k, v in got.items()} == want
    for nbits in (3, 4, 8):
        assert tcm.packed_weight_bytes(tcfg, nbits) == (
            jcm.packed_weight_bytes(jcfg, nbits))
    assert "TP2 comm time" in tcm.two_host_recipe(tcfg, 8, 2)
