"""The data axis of the port's quantizer against the JAX package's
(mirrors tests/test_parallel.py:47-66, 85-128 and
tests/test_quantize_parallel.py:52-60): two gloo ranks of a (data 2,
model 1) mesh merge partial statistics with ``finalize_psum``, calibrate
on their rows of each batch, and solve the layers of each shape group
between them (``quantize_model(layer_parallel=True, mesh=)``), held to
JAX's ``finalize_psum`` under ``shard_map``, its serial ``calibrate`` and
its mesh-sharded ``quantize_model``, and to the port's single-process
batched route bit for bit."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import PartitionSpec as P

from sleekit_tpu import hessian as jh
from sleekit_tpu.models import quantize as jq
from sleekit_tpu.models.transformer import init_params as j_init
from sleekit_tpu.models.zoo import tiny_test as j_tiny
from sleekit_tpu.parallel import mesh as jmesh
from sleekit_tpu.pipeline import QuantConfig as JQuantConfig
from sleekit_tpu_torch import hessian as th
from sleekit_tpu_torch.models import quantize as tq
from sleekit_tpu_torch.models import transformer as ttr
from sleekit_tpu_torch.models.zoo import tiny_test
from sleekit_tpu_torch.parallel.mesh import Mesh
from sleekit_tpu_torch.pipeline import QuantConfig

from tests._torch_port_util import (  # noqa: F401 (a fixture)
    one_torch_thread, same_codewords, to_numpy_tree)
from tests._torch_tp_ranks import Ranks, same_on_every_rank
from tests.test_torch_quantize_parallel import QCFG, workload  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# JAX's tolerances in tests/test_parallel.py: the merge sums the ranks'
# count-weighted statistics in another order than the serial update.
H_TOL, MEAN_TOL = dict(rtol=1e-4, atol=1e-5), dict(rtol=1e-4, atol=1e-6)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    with Ranks(2, tmp_path_factory.mktemp("data_parallel"), data=2) as r:
        yield r


def _stats_close(got, want, what):
    """Equal counts; Hessians and means within JAX's tolerances."""
    assert float(got["count"]) == float(want.count), what
    np.testing.assert_allclose(got["hessian"], np.asarray(want.hessian),
                               err_msg=what, **H_TOL)
    np.testing.assert_allclose(got["mean"], np.asarray(want.mean),
                               err_msg=what, **MEAN_TOL)


def test_finalize_psum_matches_jax(ranks):
    """JAX's four uneven shards (10, 12, 14 and 16 samples of 16
    features), two a rank: the merged statistics on both ranks, within
    JAX's tolerance of its ``finalize_psum`` under ``shard_map`` (one
    shard a device of a data-4 mesh) and of the serial ``update_stats``;
    three all-reduces; ``finalize_psum(stats, None)`` is the identity."""
    n = 16
    rng = np.random.RandomState(3)
    xs = [rng.randn(10 + 2 * i, n).astype(np.float32) for i in range(4)]
    serial = jh.init_stats(n)
    for x in xs:
        serial = jh.update_stats(serial, jnp.asarray(x))
    padded = np.zeros((4, 16, n), np.float32)
    for i, x in enumerate(xs):
        padded[i, :len(x)] = x
    counts = np.asarray([len(x) for x in xs], np.float32)

    def per_device(batch, count):
        batch, count = batch[0], count[0]
        mask = (jnp.arange(batch.shape[0]) < count).astype(jnp.float32)
        xm = batch * mask[:, None]
        st = jh.LayerStats(mean=jnp.sum(xm, 0) / jnp.maximum(count, 1.0),
                           hessian=xm.T @ xm / jnp.maximum(count, 1.0),
                           count=count)
        return jh.finalize_psum(st, "data")

    data_mesh = jmesh.make_mesh(data=4, model=1)
    with data_mesh:
        merged = jax.shard_map(per_device, mesh=data_mesh,
                               in_specs=(P("data"), P("data")),
                               out_specs=P())(jnp.asarray(padded),
                                              jnp.asarray(counts))
    res = ranks("finalize_job", shards=xs, n=n)
    for key in ("mean", "hessian", "count"):
        same_on_every_rank(res, key)
    assert res[0]["counts"] == {"all_reduce": 3, "all_gather": 0}
    assert float(res[0]["count"]) == sum(len(x) for x in xs)
    _stats_close(res[0], merged, "vs JAX's finalize_psum")
    _stats_close(res[0], serial, "vs the serial update_stats")
    st = th.init_stats(n, device="cpu")
    assert th.finalize_psum(st, None) is st


def test_calibrate_over_data_ranks_matches_jax(ranks):
    """tests/test_parallel.py's calibration: 8 x 16 tokens, each rank
    calibrating on its 4 rows and the statistics merged over the data
    axis (three all-reduces an entry), equal on both ranks and within
    JAX's tolerance of its serial ``calibrate`` over all 8 rows."""
    jcfg = j_tiny(n_layers=2, d_model=64, n_heads=4)
    tcfg = tiny_test(n_layers=2, d_model=64, n_heads=4)
    jp = j_init(jcfg, jax.random.PRNGKey(0))
    tokens = np.random.RandomState(1).randint(
        0, jcfg.vocab_size, (8, 16)).astype(np.int32)
    serial = jq.calibrate(jcfg, jp, [tokens])
    res = ranks("calibrate_job", cfg=tcfg, params=to_numpy_tree(jp),
                batches=[tokens])
    assert set(res[0]["stats"]) == set(serial)
    assert res[0]["counts"] == {"all_reduce": 3 * len(serial),
                                "all_gather": 0}
    for name, want in serial.items():
        for key in ("mean", "hessian", "count"):
            np.testing.assert_array_equal(res[1]["stats"][name][key],
                                          res[0]["stats"][name][key])
        _stats_close(res[0]["stats"][name], want, name)


@pytest.mark.parametrize("case", ["rows", "model-axis"])
def test_calibrate_refusals(case):
    """A batch whose rows do not split over the data axis raises, as
    JAX's sharding does; a mesh with a model axis raises, naming its
    ROADMAP line (statistics from a tensor-parallel forward)."""
    cfg = tiny_test(n_layers=1, d_model=32, n_heads=2)
    params = ttr.init_params(cfg, seed=0, device="cpu")
    tokens = np.zeros((3, 8), np.int32)
    cpu = torch.device("cpu")
    if case == "rows":
        with pytest.raises(ValueError, match="3 rows.*data=2"):
            tq.calibrate(cfg, params, [tokens],
                         mesh=Mesh(rank=0, model=1, device=cpu, data=2))
    else:
        with pytest.raises(NotImplementedError,
                           match="ROADMAP.*tensor-parallel calibration"):
            tq.calibrate(cfg, params, [tokens],
                         mesh=Mesh(rank=0, model=2, device=cpu))


def _numpy_stats(stats):
    return {k: dict(mean=v.mean.numpy(), hessian=v.hessian.numpy(),
                    count=v.count.numpy()) for k, v in stats.items()}


def test_mesh_solve_matches_single_process_and_jax(ranks, workload,
                                                   tmp_path):
    """tests/test_quantize_parallel.py's workload solved over the two
    ranks: 12 q/k/v/o (6 a rank), then 3 fc1 and 3 fc2, each padded to
    4 by repeating its first layer; one all-reduce (the chunk) and four
    all-gathers a chunk. Both ranks return the port's single-process
    batched route's weights and errors bit for bit, and rank 0's
    artifacts hold JAX's ``mesh=make_mesh(data=8, model=1)`` codewords
    (one linear may take the allowance stated in
    tests/test_torch_quantize_parallel.py: layers.1.o, 1% of its
    codewords and of its error)."""
    jcfg, jp, jstats, tcfg, tp, tstats = workload
    cfg = QuantConfig(**QCFG)
    want, wrep = tq.quantize_model(tcfg, tp, tstats, cfg,
                                   layer_parallel=True)
    res = ranks("quantize_job", cfg=tcfg, params=to_numpy_tree(jp),
                stats=_numpy_stats(tstats), qconfig=QCFG,
                resume_dir=str(tmp_path / "port"))
    for r in res:
        assert r["chunks"] == [12, 3, 3]
        assert r["counts"] == {"all_reduce": 3, "all_gather": 12}
        assert r["errors"] == {x.name: x.error for x in wrep}
        for name in ttr.layer_names(tcfg):
            np.testing.assert_array_equal(
                r["kernels"][name],
                ttr.get_linear_param(want, name)["kernel"].numpy(),
                err_msg=name)
    _, jrep = jq.quantize_model(jcfg, jp, jstats, JQuantConfig(**QCFG),
                                layer_parallel=True,
                                mesh=jmesh.make_mesh(data=8, model=1),
                                resume_dir=str(tmp_path / "jax"))
    ej = {x.name: x.error for x in jrep}
    cb = cfg.make_codebook()
    ties = []
    for name in ttr.layer_names(tcfg):
        got = tq._load_layer_artifact(str(tmp_path / "port"), name, "cpu")
        jz = np.load(tq._layer_artifact_path(str(tmp_path / "jax"), name))
        scale = got[2][:, None]
        got_q, want_q = got[0] / scale, jz["Q"] / scale.numpy()
        differ = (cb.quantize_index(got_q).numpy()
                  != cb.quantize_index(torch.from_numpy(want_q)).numpy())
        if not differ.any():
            same_codewords(got_q, want_q, cb, name)
            assert res[0]["errors"][name] == pytest.approx(ej[name],
                                                           rel=1e-4), name
        else:
            ties.append(name)
            assert differ.mean() <= 0.01, name
            assert res[0]["errors"][name] == pytest.approx(ej[name],
                                                           rel=1e-2), name
    assert len(ties) <= 1, ties


def test_mesh_solve_resumes_from_rank_0s_artifacts(ranks, workload,
                                                   tmp_path):
    """Rank 0 writes an artifact a layer; a rerun over the ranks loads
    them all (nothing solved, the same packed words), and after two are
    removed solves only those two, one chunk of each shape (padded to
    the two ranks); the port's single-process route resumes from them
    too."""
    _, jp, _, tcfg, tp, tstats = workload
    kw = dict(cfg=tcfg, params=to_numpy_tree(jp), stats=_numpy_stats(tstats),
              qconfig=QCFG, resume_dir=str(tmp_path), pack=True)
    first = ranks("quantize_job", **kw)
    assert len(list(tmp_path.glob("*.npz"))) == len(ttr.layer_names(tcfg))
    again = ranks("quantize_job", **kw)
    for name in ("layers.1.q", "layers.2.fc2"):
        (tmp_path / (name.replace(".", "_") + ".npz")).unlink()
    third = ranks("quantize_job", **kw)
    for r in again:
        assert r["chunks"] == [] and set(r["walls"].values()) == {0.0}
    for r in third:
        assert r["chunks"] == [1, 1]
        assert [n for n, w in r["walls"].items() if w > 0] == [
            "layers.1.q", "layers.2.fc2"]
    single, _ = tq.quantize_model(tcfg, tp, {}, QuantConfig(**QCFG),
                                  pack=True, resume_dir=str(tmp_path))
    for name in ttr.layer_names(tcfg):
        words = first[0]["kernels"][name]
        for r in (*first, *again, *third):
            np.testing.assert_array_equal(r["kernels"][name], words,
                                          err_msg=name)
        np.testing.assert_array_equal(
            ttr.get_linear_param(single, name).packed.numpy(), words,
            err_msg=name)


def test_mesh_chunks_agree_across_ranks(ranks, workload):
    """Budgets of 4 and 2 GB on the two ranks, each shared by the two
    ranks on this host's CPU, at 0.45 GB a lane: rank 0 alone would take
    4 layers a chunk and rank 1 two, and the ranks agree on the smaller
    (4 layers, 2 a rank; the fc1 and fc2 groups in one chunk of 3 each),
    with the weights of the unchunked run."""
    _, jp, _, tcfg, tp, tstats = workload
    kw = dict(cfg=tcfg, params=to_numpy_tree(jp), stats=_numpy_stats(tstats),
              qconfig=QCFG)
    whole = ranks("quantize_job", **kw)
    res = ranks("quantize_job", budgets=[4e9, 2e9], workspace=0.45e9, **kw)
    for r in res:
        assert r["chunks"] == [4, 4, 4, 3, 3]
        assert r["counts"]["all_reduce"] == 5
        for name in ttr.layer_names(tcfg):
            np.testing.assert_array_equal(r["kernels"][name],
                                          whole[0]["kernels"][name],
                                          err_msg=name)
