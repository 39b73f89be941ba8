"""The port's whole-model quantization against the JAX package's on tiny
models (mirrors tests/test_models.py and tests/test_quality.py):
calibration statistics within 1e-5, ``quantize_model`` on the same
codewords (packed words bit for bit), resume artifacts shared by the two
packages, and the skq2 round trip: a tiny OPT the port calibrates,
quantizes, packs and saves serves in the JAX package's Engine with the
port Engine's greedy tokens."""

import numpy as np
import jax
import pytest
import torch

from sleekit_tpu.models import quantize as jq
from sleekit_tpu.models import transformer as jtr
from sleekit_tpu.models.zoo import tiny_test as j_tiny
from sleekit_tpu.pipeline import preset_config as j_preset
from sleekit_tpu.serve import checkpoint as jckpt
from sleekit_tpu.serve.engine import Engine as JEngine, Request as JRequest
from sleekit_tpu_torch.convert import params_from_numpy
from sleekit_tpu_torch.models import quantize as tq
from sleekit_tpu_torch.models import transformer as ttr
from sleekit_tpu_torch.models.data import calibration_batches, synthetic_stream
from sleekit_tpu_torch.models.zoo import tiny_test
from sleekit_tpu_torch.ops.pack import PackedLinear
from sleekit_tpu_torch.pipeline import preset_config
from sleekit_tpu_torch.serve import checkpoint as tckpt
from sleekit_tpu_torch.serve.engine import Engine, Request

from tests._torch_port_util import (  # noqa: F401 (a fixture)
    one_torch_thread, same_codewords, to_numpy_tree)

FAMILIES = {
    "opt": dict(),
    "bloom": dict(activation="gelu", positional="alibi", embed_ln=True),
    "llama": dict(activation="silu_glu", norm="rmsnorm", positional="rope",
                  n_kv_heads=2, tie_embeddings=False),
}

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _models(family="opt", **kw):
    """(JAX cfg, JAX dense params, port cfg, the same params in the
    port, on the CPU)."""
    geo = dict(FAMILIES[family], **kw)
    jcfg, tcfg = j_tiny(**geo), tiny_test(**geo)
    jp = jtr.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, jp, tcfg, params_from_numpy(tcfg, to_numpy_tree(jp),
                                             device="cpu")


def _batches(n=4, t=24):
    return calibration_batches(synthetic_stream(256, n * t, seed=3), n, t)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_calibrate_matches_jax(family):
    """calibrate (every linear's statistics, the projections unfused)
    agrees with the JAX package's within 1e-5 of each Hessian's largest
    entry; forward(stats=...) returns the plain forward's logits."""
    jcfg, jp, tcfg, tp = _models(family)
    batches = _batches()
    want = jq.calibrate(jcfg, jp, batches)
    got = tq.calibrate(tcfg, tp, batches)
    assert list(got) == ttr.layer_names(tcfg) == jtr.layer_names(jcfg)
    for name, st in got.items():
        assert float(st.count) == float(want[name].count) == 4 * 24
        for f in ("mean", "hessian"):
            w = np.asarray(getattr(want[name], f))
            np.testing.assert_allclose(getattr(st, f).numpy(), w, rtol=0,
                                       atol=1e-5 * np.abs(w).max(),
                                       err_msg=f"{name} {f}")
    tokens = torch.from_numpy(batches[0])
    logits, stats = ttr.forward(tcfg, tp, tokens,
                                stats=ttr.init_calibration_stats(tcfg, "cpu"))
    np.testing.assert_allclose(logits.numpy(),
                               ttr.forward(tcfg, tp, tokens).numpy(),
                               rtol=1e-5, atol=1e-6)
    assert float(stats["layers.1.q"].count) == 2 * 24


def test_quantize_model_matches_jax(tmp_path):
    """quantize_model (light, 4 bits) dense and packed: the JAX package's
    codewords, packed words bit for bit, reports' errors within 1e-5; a
    resume directory the JAX package wrote is loaded, not solved, and a
    second port run on its own directory solves nothing."""
    jcfg, jp, tcfg, tp = _models()
    batches = _batches()
    jstats = jq.calibrate(jcfg, jp, batches)
    tstats = tq.calibrate(tcfg, tp, batches)
    jparams, jrep = jq.quantize_model(jcfg, jp, jstats, j_preset("light", 4),
                                      resume_dir=str(tmp_path / "jax"))
    cfg = preset_config("light", 4)
    cb = cfg.make_codebook()
    tparams, trep = tq.quantize_model(tcfg, tp, tstats, cfg)
    assert [r.name for r in trep] == ttr.layer_names(tcfg)
    for jr, tr in zip(jrep, trep):
        assert tr.error == pytest.approx(jr.error, rel=1e-5)
        assert tr.wall_s > 0
    packed, _ = tq.quantize_model(tcfg, tp, tstats, cfg, pack=True,
                                  resume_dir=str(tmp_path / "port"))
    jpacked, _ = jq.quantize_model(jcfg, jp, jstats, j_preset("light", 4),
                                   pack=True, resume_dir=str(tmp_path / "jax"))
    for name in ttr.layer_names(tcfg):
        want = np.asarray(jtr.get_linear_param(jparams, name)["kernel"]).T
        got = ttr.get_linear_param(tparams, name)["kernel"].T
        scale = ttr.get_linear_param(packed, name).scale
        same_codewords(got / scale[:, None], want / scale[:, None].numpy(),
                       cb, name)
        np.testing.assert_allclose(
            ttr.get_linear_param(tparams, name)["bias"].numpy(),
            np.asarray(jtr.get_linear_param(jparams, name)["bias"]),
            rtol=0, atol=1e-5)
        p, jpk = (ttr.get_linear_param(packed, name),
                  jtr.get_linear_param(jpacked, name))
        assert isinstance(p, PackedLinear) and p.layout == jpk.layout == "pair"
        np.testing.assert_array_equal(p.packed.numpy(), np.asarray(jpk.packed))
        np.testing.assert_allclose(p.scale.numpy(), np.asarray(jpk.scale),
                                   rtol=1e-6)
    # The JAX package's artifacts, loaded: nothing solved, its weights.
    resumed, rep = tq.quantize_model(tcfg, tp, tstats, cfg,
                                     resume_dir=str(tmp_path / "jax"))
    assert all(r.wall_s == 0.0 for r in rep)
    for name in ttr.layer_names(tcfg):
        np.testing.assert_array_equal(
            ttr.get_linear_param(resumed, name)["kernel"].numpy(),
            np.asarray(jtr.get_linear_param(jparams, name)["kernel"]))
    # The port's own: the dense weights of the packed run's solve.
    again, rep = tq.quantize_model(tcfg, tp, {}, cfg,
                                   resume_dir=str(tmp_path / "port"))
    assert all(r.wall_s == 0.0 for r in rep)
    name = "layers.1.fc2"
    torch.testing.assert_close(
        ttr.get_linear_param(again, name)["kernel"],
        ttr.get_linear_param(packed, name).dequantize(), rtol=0, atol=1e-6)
    # The caller's params are untouched.
    assert not isinstance(ttr.get_linear_param(tp, name), PackedLinear)


def test_free_stats_host_stats_and_pack_host():
    """free_stats pops each solved entry from the caller's dict; host
    statistics (here a model on the CPU, so the same device) solve as
    device ones; pack_host packs on the CPU; the serial route ignores a
    ``mesh``, as the JAX package's does (layer_parallel:
    tests/test_torch_quantize_parallel.py; the mesh solve:
    tests/test_torch_data_parallel.py)."""
    _, _, tcfg, tp = _models(n_layers=1)
    stats = tq.calibrate(tcfg, tp, _batches(2, 16))
    kept = dict(stats)
    cfg = preset_config("basic", 3, grid_size=10)
    a, _ = tq.quantize_model(tcfg, tp, stats, cfg, pack=True, free_stats=True)
    assert stats == {}
    b, _ = tq.quantize_model(tcfg, tp, kept, cfg, pack=True, pack_host=True)
    for name in ttr.layer_names(tcfg):
        pa, pb = ttr.get_linear_param(a, name), ttr.get_linear_param(b, name)
        assert pb.packed.device.type == "cpu"
        assert torch.equal(pa.packed, pb.packed)
    c, _ = tq.quantize_model(tcfg, tp, kept, cfg, pack=True, mesh=object())
    for name in ttr.layer_names(tcfg):
        assert torch.equal(ttr.get_linear_param(c, name).packed,
                           ttr.get_linear_param(a, name).packed)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_calibrate_spill_matches_calibrate_and_jax(family):
    """Layer-outer calibration with host statistics: the port's
    ``calibrate`` bit for bit (each layer's input comes from the same ops,
    its statistics updated batch by batch in the same order), on the CPU,
    in layer order; and the JAX package's ``calibrate_spill`` within its
    own test's tolerance (rtol and atol 1e-6; tests/test_models.py)."""
    jcfg, jp, tcfg, tp = _models(family, n_layers=3)
    rng = np.random.RandomState(0)
    batches = [rng.randint(0, tcfg.vocab_size, (2, 16)).astype(np.int32)
               for _ in range(3)]
    got = tq.calibrate_spill(tcfg, tp, batches)
    want = tq.calibrate(tcfg, tp, batches)
    jwant = jq.calibrate_spill(jcfg, jp, batches)
    assert list(got) == list(want) == list(jwant) == ttr.layer_names(tcfg)
    for name, st in got.items():
        for f in ("mean", "hessian", "count"):
            x = getattr(st, f)
            assert x.device.type == "cpu"
            assert torch.equal(x, getattr(want[name], f)), (name, f)
        for f in ("mean", "hessian"):
            np.testing.assert_allclose(getattr(st, f).numpy(),
                                       getattr(jwant[name], f), rtol=1e-6,
                                       atol=1e-6, err_msg=f"{name} {f}")
        assert int(st.count) == int(jwant[name].count)


def test_skq2_round_trip_serves_in_jax(tmp_path):
    """The port calibrates, quantizes (light, 4 bits) and packs a tiny OPT
    (q|k|v fused, int8 head) and saves it as skq2; the JAX package loads
    the checkpoint, and its Engine's greedy tokens equal the port
    Engine's on the same prompts."""
    _, _, tcfg, tp = _models()
    params, _ = tq.quantize_model_from_batches(
        tcfg, tp, _batches(), preset_config("light", 4), pack=True)
    params = tq.pack_lm_head(tcfg, ttr.fuse_qkv_params(tcfg, params))
    tckpt.save_packed_params(str(tmp_path), params, meta={"nbits": 4})
    jparams, meta = jckpt.load_packed_params(str(tmp_path))
    assert meta == {"nbits": 4}
    assert jparams["layers"][0]["attn"]["qkv"].layout == "pair"
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, 256, n).astype(np.int32) for n in (5, 17, 9)]
    want = JEngine(j_tiny(), jparams, max_slots=2, max_seq_len=64).run(
        [JRequest(prompt=p, max_new_tokens=8) for p in prompts])
    got = Engine(tcfg, params, max_slots=2, max_seq_len=64,
                 device="cpu").run(
        [Request(prompt=p, max_new_tokens=8) for p in prompts])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.tokens, w.tokens)
