"""Replica serving in the port against the JAX package's (mirrors
tests/test_router.py, tests/test_engine_tp.py:56 and
tests/test_paged_engine.py:104): four gloo ranks, a (data 2, model 2)
mesh, each rank holding only its replica behind a ``ReplicaRouter``,
serve a tiny packed model built by the JAX package with the greedy tokens
of JAX's router over ``replica_meshes(2, 2)`` and of JAX's
``Engine(mesh=make_mesh(data=2, model=2))``, and the tokens of the port's
standalone Engine fed each replica's requests, greedy and sampled, slot
and paged; every collective while serving stays in a replica's model
group. In one process: replicas on the CPU, a router over part of the
replicas, and the refusals. JAX's TP prefill gets the head-width scale
fix described in tests/test_torch_tp_decode.py."""

import numpy as np
import jax
import pytest
import torch

from sleekit_tpu.codebooks import UniformCodebook as JUniform
from sleekit_tpu.models.fake_quant import random_packed_params as j_random
from sleekit_tpu.models.quantize import pack_lm_head as j_pack_head
from sleekit_tpu.models.zoo import tiny_test as j_tiny
from sleekit_tpu.parallel import mesh as jmesh
from sleekit_tpu.serve import router as jrouter
from sleekit_tpu.serve.engine import Engine as JEngine, Request as JRequest
from sleekit_tpu_torch.convert import params_from_numpy
from sleekit_tpu_torch.models.zoo import tiny_test
from sleekit_tpu_torch.parallel.mesh import Mesh
from sleekit_tpu_torch.serve.engine import Engine, Request
from sleekit_tpu_torch.serve.router import ReplicaRouter, replica_meshes

from tests._torch_port_util import to_numpy_tree
from tests._torch_tp_ranks import Ranks
from tests.test_torch_tp_decode import jax_head_dim_fix  # noqa: F401

GEO = dict(d_model=64, n_heads=4, n_layers=2, d_ff=128, vocab_size=256)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Four ranks: replicas 0 (ranks 0, 1) and 1 (ranks 2, 3) of two."""
    with Ranks(4, tmp_path_factory.mktemp("router"), data=2) as r:
        yield r


@pytest.fixture(scope="module")
def model():
    """(JAX cfg, JAX params, port cfg, numpy tree): tests/test_router.py's
    int4 'pair' model with an int8 head."""
    jcfg = j_tiny(**GEO)
    jp, _ = j_random(jcfg, jax.random.PRNGKey(0), JUniform(16, -1.0, 1.0))
    jp = j_pack_head(jcfg, jp, nbits=8)
    return jcfg, jp, tiny_test(**GEO), to_numpy_tree(jp)


def _specs(n=5, sampled=False, **kw):
    """tests/test_router.py's requests as dicts of ``Request``'s fields:
    prompts of 3 + 2i tokens, 4 + i % 3 new ones; request 2 sampled at
    temperature 0.8 with ``sampled`` (``kw`` added to it), the rest
    greedy."""
    rng = np.random.RandomState(3)
    out = []
    for i in range(n):
        spec = dict(prompt=rng.randint(0, 256, (3 + 2 * i,)).astype(np.int32),
                    max_new_tokens=4 + (i % 3))
        if sampled and i == 2:
            spec.update(temperature=0.8, **kw)
        out.append(spec)
    return out


def _standalone(tcfg, tree, specs, **kw):
    """The port's single-device Engine's new tokens for ``specs``."""
    engine = Engine(tcfg, params_from_numpy(tcfg, tree, device="cpu"),
                    device="cpu", **kw)
    return [c.new_tokens.tolist() for c in engine.run(
        [Request(**spec) for spec in specs])]


def _over_ranks(ranks, tcfg, tree, specs, kw):
    """The routers' tokens by request id, after checking that both ranks
    of a replica served its requests alike, that request i went to
    replica i % 2, and that every collective while serving stayed in the
    replica's model group: two all-reduces a layer and one all-gather a
    prefill or decode step, none over the data group or the world."""
    res = ranks("router_tokens", cfg=tcfg, params=tree, specs=specs,
                engine_kw=kw)
    got = {}
    for rank, r in enumerate(res):
        assert r["replica"] == rank // 2
        assert r["model_ranks"] == [2 * (rank // 2), 2 * (rank // 2) + 1]
        assert r["data_ranks"] == [rank % 2, rank % 2 + 2]
        assert r["owners"] == [i % 2 for i in range(len(specs))]
        assert r["ids"] == list(range(r["replica"], len(specs), 2))
        assert {tuple(g) for _, g in r["collectives"]} == {
            tuple(r["model_ranks"])}
        counts = r["counts"]
        assert counts["all_gather"] > 0
        assert counts["all_reduce"] == 2 * tcfg.n_layers * counts[
            "all_gather"]
        assert [n for n, _ in r["collectives"]].count("all_reduce") == (
            counts["all_reduce"])
        for i, toks in zip(r["ids"], r["tokens"]):
            toks = np.asarray(toks).tolist()
            assert got.setdefault(i, toks) == toks, (rank, i)
    return [got[i] for i in range(len(specs))]


@pytest.mark.usefixtures("jax_head_dim_fix")
@pytest.mark.parametrize("paged", [False, True])
def test_router_over_ranks_matches_jax(ranks, model, paged):
    """Greedy requests through two TP-2 replicas, slot and paged: each
    request's tokens are those of the port's standalone Engine fed its
    replica's requests (same geometry and seed), of JAX's router over
    ``replica_meshes(2, 2)`` and of JAX's single-process
    ``Engine(make_mesh(data=2, model=2))`` (two slots a replica)."""
    jcfg, jp, tcfg, tree = model
    specs = _specs()
    kw = dict(max_slots=2, max_seq_len=32, seed=0, paged=paged,
              page_size=16)
    got = _over_ranks(ranks, tcfg, tree, specs, kw)
    for rep in (0, 1):
        assert got[rep::2] == _standalone(tcfg, tree, specs[rep::2], **kw)
    jtp = jmesh.prepare_params_for_tp(jcfg, jp, 2)
    jr = jrouter.ReplicaRouter(jcfg, jtp, jrouter.replica_meshes(2, 2), **kw)
    assert [c.new_tokens.tolist() for c in jr.run(
        [JRequest(**s) for s in specs])] == got
    je = JEngine(jcfg, jtp, mesh=jmesh.make_mesh(data=2, model=2),
                 **dict(kw, max_slots=4))
    assert [c.new_tokens.tolist() for c in je.run(
        [JRequest(**s) for s in specs])] == got


@pytest.mark.parametrize("sampling", [{}, dict(top_k=5, top_p=0.9)])
def test_router_over_ranks_sampled_matches_standalone(ranks, model,
                                                      sampling):
    """A sampled request (temperature 0.8; then with top-k and top-p)
    among greedy ones, through the fused steps: each replica draws from a
    generator of the Engine's seed, so the router emits the standalone
    Engine's tokens for each replica's requests, token for token."""
    _, _, tcfg, tree = model
    specs = _specs(sampled=True, **sampling)
    kw = dict(max_slots=2, max_seq_len=32, seed=3, fused_steps=4)
    got = _over_ranks(ranks, tcfg, tree, specs, kw)
    for rep in (0, 1):
        assert got[rep::2] == _standalone(tcfg, tree, specs[rep::2], **kw)


@pytest.mark.parametrize("paged", [False, True])
def test_replica_meshes_on_the_cpu(model, paged):
    """``replica_meshes(4, devices=["cpu"] * 4)``: four one-rank meshes,
    each replica a single-device Engine with its params and cache on the
    CPU; request i on replica i % 4, and each replica's tokens (one
    sampled request among them) those of a standalone Engine fed its
    requests."""
    _, _, tcfg, tree = model
    meshes = replica_meshes(4, devices=["cpu"] * 4)
    assert [(m.model, m.data_rank, m.device.type) for m in meshes] == [
        (1, r, "cpu") for r in range(4)]
    kw = dict(max_slots=2, max_seq_len=32, seed=0, paged=paged,
              page_size=16)
    router = ReplicaRouter(tcfg, params_from_numpy(tcfg, tree, device="cpu"),
                           meshes, **kw)
    for e in router.engines.values():
        assert e.mesh is None and e.device.type == "cpu"
        assert all(t.device.type == "cpu" for t in e.cache.values())
    specs = _specs(n=6, sampled=True)
    comps = router.run([Request(**s) for s in specs])
    assert [c.request_id for c in comps] == list(range(6))
    assert [router.owner(i) for i in range(6)] == [0, 1, 2, 3, 0, 1]
    got = [c.new_tokens.tolist() for c in comps]
    for rep in range(4):
        assert got[rep::4] == _standalone(tcfg, tree, specs[rep::4], **kw)


def test_router_partial_local_replicas(model):
    """A router holding only replica 1 of two serves exactly requests 1
    and 3, with the full router's tokens for them."""
    _, _, tcfg, tree = model
    params = params_from_numpy(tcfg, tree, device="cpu")
    meshes = replica_meshes(2, devices=["cpu", "cpu"])
    kw = dict(max_slots=2, max_seq_len=32, seed=0)
    full = ReplicaRouter(tcfg, params, meshes, **kw).run(
        [Request(**s) for s in _specs()])
    part = ReplicaRouter(tcfg, params, [meshes[1]], replica_ids=[1],
                         n_replicas=2, **kw)
    out = part.run([Request(**s) for s in _specs()])
    assert [c.request_id for c in out] == [1, 3]
    assert list(part.engines) == [1]
    for c in out:
        assert c.new_tokens.tolist() == full[c.request_id].new_tokens.tolist()


@pytest.mark.parametrize("case", ["tp-in-one-process", "devices",
                                  "engine-data-axis", "engine-over-ranks"])
def test_refusals(ranks, model, case):
    """A replica of model > 1 ranks in one process (each rank takes
    ``local_replica_mesh``), more replicas than CUDA devices by default,
    and ``Engine(mesh=)`` over a mesh with a data axis (in one process,
    and over the four ranks' (2, 2) mesh) are refused, each naming what
    serves it."""
    _, _, tcfg, tree = model
    if case == "tp-in-one-process":
        with pytest.raises(ValueError, match="local_replica_mesh"):
            replica_meshes(2, 2)
    elif case == "devices":
        found = torch.cuda.device_count()
        with pytest.raises(RuntimeError, match=f"found {found}"):
            replica_meshes(found + 1)
    elif case == "engine-data-axis":
        mesh = Mesh(rank=0, model=1, device=torch.device("cpu"), data=2)
        with pytest.raises(ValueError, match="ReplicaRouter"):
            Engine(tcfg, params_from_numpy(tcfg, tree, device="cpu"),
                   mesh=mesh)
    else:
        for msg in ranks("router_tokens", cfg=tcfg, params=tree, specs=[],
                         engine_kw={}, engine_on_mesh=True):
            assert "data=2" in msg and "ReplicaRouter" in msg
