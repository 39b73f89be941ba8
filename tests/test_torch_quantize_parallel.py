"""The port's batched layer solve, ``quantize_model(layer_parallel=True)``,
against its serial route and the JAX package's ``layer_parallel=True``
(mirrors tests/test_quantize_parallel.py, on its workload): errors within
rel 1e-4, dense leaves within 1e-5, the JAX package's codewords; each
order and scaling mode, heavy and NF4 batched against per-lane serial
solves; a rank-deficient lane that retries while its neighbours keep
multiplier 1; chunks of 1, 2 and all with equal words; lloyd serial;
resume artifacts and ``free_stats`` together with ``layer_parallel``."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sleekit_tpu import hessian as jh
from sleekit_tpu.models import quantize as jq
from sleekit_tpu.models import transformer as jtr
from sleekit_tpu.models.zoo import tiny_test as j_tiny
from sleekit_tpu.pipeline import QuantConfig as JQuantConfig
from sleekit_tpu_torch import hessian as th
from sleekit_tpu_torch.convert import params_from_numpy
from sleekit_tpu_torch.models import quantize as tq
from sleekit_tpu_torch.models import transformer as ttr
from sleekit_tpu_torch.models.zoo import tiny_test
from sleekit_tpu_torch.pipeline import (
    QuantConfig, preset_config, quantize_layer)

from tests._torch_port_util import (  # noqa: F401 (a fixture)
    one_torch_thread, quant_problem, same_codewords, to_numpy_tree)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

GEO = dict(d_model=64, n_heads=4, n_layers=3, d_ff=128, vocab_size=128)
QCFG = dict(nbits=4, scaling_mode="diag", grid_size=12, block_size=32)


@pytest.fixture(scope="module")
def workload():
    """tests/test_quantize_parallel.py's workload in both packages: (JAX
    cfg, params, stats; port cfg, params, stats)."""
    jcfg, tcfg = j_tiny(**GEO), tiny_test(**GEO)
    jp = jtr.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(tcfg, to_numpy_tree(jp), device="cpu")
    rng = np.random.RandomState(1)
    batches = [rng.randint(0, jcfg.vocab_size, (2, 24)).astype(np.int32)
               for _ in range(2)]
    return (jcfg, jp, jq.calibrate(jcfg, jp, batches), tcfg, tp,
            tq.calibrate(tcfg, tp, batches))


def _errors(reports):
    return {r.name: r.error for r in reports}


def _kernels(cfg, params):
    return {n: ttr.get_linear_param(params, n)["kernel"]
            for n in ttr.layer_names(cfg)}


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def test_layer_parallel_matches_serial_and_jax(workload, tmp_path):
    """Batched against the port's serial route (errors rel 1e-4, every
    leaf within 1e-5) and against the JAX package's batched route (the
    same codewords, errors rel 1e-4), reports in layer order with each
    chunk's wall shared out.

    One linear may miss the JAX package's codewords: on this workload
    layers.1.o's sweep meets a value 1 f32 step from a rounding boundary
    (8.500001 on the grid, column 12) that XLA's fused multiply-add in the
    uniform codebook puts on the other side, in the serial routes too
    (ROADMAP, faults); the flip moves 17 of its 4,096 codewords and 0.4%
    of its error. Such a linear is held to at most 1% of its codewords
    and 1% of its error."""
    jcfg, jp, jstats, tcfg, tp, tstats = workload
    cfg = QuantConfig(**QCFG)
    serial, rs = tq.quantize_model(tcfg, tp, tstats, cfg)
    par, rp = tq.quantize_model(tcfg, tp, tstats, cfg, layer_parallel=True,
                                resume_dir=str(tmp_path / "port"))
    assert [r.name for r in rp] == ttr.layer_names(tcfg)
    assert all(r.wall_s > 0 for r in rp)
    es, ep = _errors(rs), _errors(rp)
    for k in es:
        assert ep[k] == pytest.approx(es[k], rel=1e-4), k
    a, b = _leaves(serial), _leaves(par)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_allclose(y.numpy(), x.numpy(), rtol=1e-5,
                                   atol=1e-5)
    _, jrep = jq.quantize_model(jcfg, jp, jstats, JQuantConfig(**QCFG),
                                layer_parallel=True,
                                resume_dir=str(tmp_path / "jax"))
    ej = _errors(jrep)
    cb = cfg.make_codebook()
    ties = []
    for name in ttr.layer_names(tcfg):
        got = tq._load_layer_artifact(str(tmp_path / "port"), name, "cpu")
        want = np.load(tq._layer_artifact_path(str(tmp_path / "jax"), name))
        scale = got[2][:, None]
        got_q, want_q = got[0] / scale, want["Q"] / scale.numpy()
        differ = (cb.quantize_index(got_q).numpy()
                  != cb.quantize_index(torch.from_numpy(want_q)).numpy())
        if not differ.any():
            same_codewords(got_q, want_q, cb, name)
            assert ep[name] == pytest.approx(ej[name], rel=1e-4), name
        else:
            ties.append(name)
            assert differ.mean() <= 0.01, name
            assert ep[name] == pytest.approx(ej[name], rel=1e-2), name
    assert len(ties) <= 1, ties


def _stack(L, m, n, seed=0):
    """L independent problems from numpy's seed: W (L, m, n) standard
    normal, and each layer's mean and Hessian from 3n samples of mean
    0.4."""
    rng = np.random.default_rng(seed)
    W = rng.standard_normal((L, m, n)).astype(np.float32)
    X = (rng.standard_normal((L, 3 * n, n)) + 0.4).astype(np.float32)
    H = np.einsum("lsi,lsj->lij", X, X) / (3 * n)
    return [torch.from_numpy(np.ascontiguousarray(x, np.float32))
            for x in (W, H, X.mean(1))]


LANE_CASES = {
    **{f"order-{m}": QuantConfig(nbits=3, order_mode=m, grid_size=8,
                                 block_size=16)
       for m in ("diag", "err", "sqerr", "combined_diag", "inv_diag",
                 "pivot", "none")},
    **{f"scaling-{m}": QuantConfig(nbits=3, scaling_mode=m, grid_size=8,
                                   block_size=16, bias_correction=True)
       for m in ("max", "norm", "mse", "diag", "diag3", "hessian",
                 "hessian10", "obq")},
    "scaling-obq-refine": QuantConfig(nbits=3, scaling_mode="obq",
                                      obq_refine=4, block_size=16),
    "heavy": preset_config("heavy", 3, grid_size=8, block_size=16),
    "nf4": preset_config("light", 4, codebook_kind="nf4", grid_size=8,
                         block_size=16),
}


@pytest.mark.parametrize("case", list(LANE_CASES))
def test_batched_layer_matches_per_lane(case):
    """quantize_layer over a stack of 3 layers (a ragged last block)
    returns, lane by lane, the serial call's (Q, bias delta, scale, error)
    on that layer: the same codewords, values within 1e-6 of the largest,
    the rest within 1e-5."""
    cfg = LANE_CASES[case]
    Ws, Hs, mus = _stack(3, 12, 40)
    out = quantize_layer(Ws, Hs, mus, cfg)
    assert [tuple(x.shape) for x in out] == [(3, 12, 40), (3, 12), (3, 12),
                                             (3, 12)]
    cb = cfg.make_codebook()
    for i in range(3):
        want = quantize_layer(Ws[i], Hs[i], mus[i], cfg)
        same_codewords(out[0][i] / out[2][i, :, None],
                       want[0] / want[2][:, None], cb, f"{case} lane {i}")
        for got, ref in zip(out[1:], want[1:]):
            torch.testing.assert_close(got[i], ref, rtol=1e-5, atol=1e-5)


def test_rank_deficient_lane_retries_alone():
    """A stack of a well-conditioned Hessian, H = [[D, D], [D, D]] (exact
    zero pivots at damp 1e-9) and a rank-deficient Wishart matrix: the
    singular lane retries at the JAX package's multiplier while its
    well-conditioned neighbour keeps 1; each lane's factor and multiplier
    are the serial call's on that lane (the Wishart lane's, whatever this
    LAPACK makes of it); and the batched solve of those Hessians is the
    per-lane one."""
    d = np.diag(np.tile(np.float32([1, 4, 9, 16]), 4))
    singular = np.block([[d, d], [d, d]]).astype(np.float32)
    _, good = quant_problem(8, 32, 3)
    wishart = th.random_psd_matrix(4, 32, 6, device="cpu")
    Hs = torch.stack([torch.from_numpy(good), torch.from_numpy(singular),
                      wishart])
    hinv, mults = th.hessian_inv_chol_robust(Hs, 1e-9)
    assert isinstance(mults, list) and len(mults) == 3
    assert mults[0] == 1.0 and mults[1] > 1.0
    _, jm = jax.vmap(lambda h: jh.hessian_inv_chol_robust(h, 1e-9))(
        jnp.asarray(Hs[:2].numpy()))
    assert mults[:2] == [float(m) for m in np.asarray(jm)]
    for i in range(3):
        want, mult = th.hessian_inv_chol_robust(Hs[i], 1e-9)
        assert isinstance(mult, float) and mult == mults[i]
        assert torch.isfinite(hinv[i]).all()
        torch.testing.assert_close(hinv[i], want, rtol=0, atol=0)
    W = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (3, 24, 32)).astype(np.float32) * 0.4)
    cfg = QuantConfig(nbits=4, damp=1e-9, scaling_mode="max")
    mus = torch.zeros(3, 32)
    out = quantize_layer(W, Hs, mus, cfg)
    for i in range(3):
        want = quantize_layer(W[i], Hs[i], mus[i], cfg)
        torch.testing.assert_close(out[0][i], want[0], rtol=0, atol=1e-6)


def test_lloyd_stays_serial(workload, monkeypatch):
    """A per-layer (lloyd) codebook takes the serial route, as in the JAX
    package: no batched solve, the serial route's result."""
    _, _, _, tcfg, tp, tstats = workload
    cfg = QuantConfig(**dict(QCFG, codebook_kind="lloyd", nbits=3))
    want, rw = tq.quantize_model(tcfg, tp, tstats, cfg)
    monkeypatch.setattr(tq, "_solve_layer_batch", None)
    got, rg = tq.quantize_model(tcfg, tp, tstats, cfg, layer_parallel=True)
    assert _errors(rg) == _errors(rw)
    for n, k in _kernels(tcfg, got).items():
        assert torch.equal(k, _kernels(tcfg, want)[n]), n


def _record_chunks(monkeypatch):
    sizes = []
    real = tq._solve_layer_batch

    def recording(params, stats, group, *a):
        sizes.append(len(group))
        return real(params, stats, group, *a)

    monkeypatch.setattr(tq, "_solve_layer_batch", recording)
    return sizes


# Per-lane workspace estimates against a 1 GB budget, and the chunks each
# cuts the groups into: 12 q/k/v/o (64 -> 64), 3 fc1, 3 fc2.
CHUNKS = {"1": (0.9e9, [1] * 18), "2": (0.45e9, [2] * 6 + [2, 1] * 2),
          "all": (1.0, [12, 3, 3])}


def _packed_words(tcfg, tp, tstats, cfg):
    packed, _ = tq.quantize_model(tcfg, tp, tstats, cfg, pack=True,
                                  layer_parallel=True)
    return {n: ttr.get_linear_param(packed, n).packed
            for n in ttr.layer_names(tcfg)}


@pytest.mark.parametrize("label", list(CHUNKS))
def test_chunks_fit_the_budget_and_keep_the_words(label, workload,
                                                  monkeypatch):
    """``QUANT_HBM_LIMIT`` 1 GB with the workspace estimate forced to 0.9,
    0.45 or ~0 GB a lane: chunks of 1, 2 or whole groups (K 64 first,
    then K 128), and the packed words of the whole groups' run (no
    budget: one chunk a group on the CPU)."""
    _, _, _, tcfg, tp, tstats = workload
    cfg = QuantConfig(**QCFG)
    monkeypatch.delenv("QUANT_HBM_LIMIT", raising=False)
    assert tq.chunk_size(torch.device("cpu"), 5, 64) == 5
    want = _packed_words(tcfg, tp, tstats, cfg)
    workspace, sizes_want = CHUNKS[label]
    monkeypatch.setenv("QUANT_HBM_LIMIT", "1e9")
    monkeypatch.setattr(tq, "solve_workspace", lambda k: workspace)
    sizes = _record_chunks(monkeypatch)
    got = _packed_words(tcfg, tp, tstats, cfg)
    assert sizes == sizes_want
    for n, w in want.items():
        assert torch.equal(got[n], w), n


def test_resume_and_free_stats_with_layer_parallel(workload, tmp_path,
                                                   monkeypatch):
    """``layer_parallel`` with ``resume_dir`` and ``free_stats``: every
    entry popped, an artifact a layer; a rerun loads them all (nothing
    solved) with the same weights; after two artifacts are removed, only
    those two layers are solved, in one chunk of their shape each."""
    _, _, _, tcfg, tp, tstats = workload
    cfg = QuantConfig(**QCFG)
    stats = dict(tstats)
    first, _ = tq.quantize_model(tcfg, tp, stats, cfg, layer_parallel=True,
                                 resume_dir=str(tmp_path),
                                 free_stats=True)
    assert stats == {}
    assert len(list(tmp_path.glob("*.npz"))) == len(ttr.layer_names(tcfg))
    sizes = _record_chunks(monkeypatch)
    again, rep = tq.quantize_model(tcfg, tp, {}, cfg, layer_parallel=True,
                                   resume_dir=str(tmp_path))
    assert sizes == [] and all(r.wall_s == 0.0 for r in rep)
    for name in ("layers.1.q", "layers.2.fc2"):
        (tmp_path / (name.replace(".", "_") + ".npz")).unlink()
    third, rep = tq.quantize_model(tcfg, tp, dict(tstats), cfg,
                                   layer_parallel=True,
                                   resume_dir=str(tmp_path))
    assert sizes == [1, 1]
    assert [r.name for r in rep if r.wall_s > 0] == ["layers.1.q",
                                                     "layers.2.fc2"]
    want = _kernels(tcfg, first)
    for got in (again, third):
        for n, k in _kernels(tcfg, got).items():
            assert torch.equal(k, want[n]), n


def test_solve_workspace_lives_in_models():
    """The CLI's memory plan and the chunks read one estimate."""
    from sleekit_tpu_torch.experiments import quantize_model_cli as cli

    assert cli.solve_workspace is tq.solve_workspace
    assert cli.hbm_limit is tq.hbm_limit
