"""The port's HF checkpoint reader and converters against the JAX
package's (mirrors tests/test_hf_parity.py): ``load_state_dict`` on
single and sharded safetensors (F32, F16, BF16) and ``pytorch_model.bin``;
each converter leaf by leaf and bit for bit on random state dicts; and,
where ``transformers`` is installed, the converted models' logits against
the HF models' within 2e-3 of the largest and against JAX's forward."""

import json
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from sleekit_tpu.models import hf as jhf
from sleekit_tpu.models.transformer import (
    TransformerConfig as JConfig, forward as jforward)
from sleekit_tpu_torch.models import hf as thf
from sleekit_tpu_torch.models.transformer import (
    TransformerConfig, forward as tforward)

from tests._torch_port_util import assert_trees_equal, hf_state_dict

GEOMETRY = {
    "opt": dict(vocab_size=97, d_model=32, n_layers=2, n_heads=4, d_ff=64,
                max_seq_len=64),
    "opt_post": dict(vocab_size=89, d_model=32, n_layers=2, n_heads=4,
                     d_ff=64, max_seq_len=64, pre_norm=False,
                     final_ln=False, embed_dim=16),
    "bloom": dict(vocab_size=101, d_model=32, n_layers=2, n_heads=4,
                  d_ff=128, max_seq_len=64, activation="gelu",
                  positional="alibi", embed_ln=True),
    "llama": dict(vocab_size=103, d_model=32, n_layers=2, n_heads=4,
                  n_kv_heads=2, d_ff=64, max_seq_len=64,
                  activation="silu_glu", norm="rmsnorm", positional="rope",
                  tie_embeddings=False, norm_eps=1e-6),
    "qwen": dict(vocab_size=103, d_model=32, n_layers=2, n_heads=4,
                 n_kv_heads=2, d_ff=64, max_seq_len=64,
                 activation="silu_glu", norm="rmsnorm", positional="rope",
                 tie_embeddings=False, norm_eps=1e-6, qkv_bias=True),
}
FAMILY = {"opt": "opt", "opt_post": "opt", "bloom": "bloom",
          "llama": "llama", "qwen": "qwen"}


def _cfgs(name):
    return JConfig(**GEOMETRY[name]), TransformerConfig(**GEOMETRY[name])


# ---- load_state_dict --------------------------------------------------------


def _tensors(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a.weight": torch.randn(6, 5, generator=g),
            "a.bias": torch.randn(6, generator=g),
            "b.weight": torch.randn(3, 4, 2, generator=g),
            "c": torch.randn(7, generator=g)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16])
@pytest.mark.parametrize("sharded", [False, True])
def test_load_state_dict_safetensors(tmp_path, dtype, sharded):
    """Single-file and index-sharded safetensors, read by the port's own
    parser: the JAX package's arrays (through the ``safetensors``
    package), f32, bit for bit; F32 and F16 also against
    ``safetensors.numpy`` directly."""
    st_torch = pytest.importorskip("safetensors.torch")
    sd = {k: v.to(dtype) for k, v in _tensors().items()}
    if sharded:
        names = sorted(sd)
        shards = {"model-00001-of-00002.safetensors": names[:2],
                  "model-00002-of-00002.safetensors": names[2:]}
        for fname, keys in shards.items():
            st_torch.save_file({k: sd[k] for k in keys},
                               str(tmp_path / fname))
        index = {"metadata": {}, "weight_map": {
            k: f for f, keys in shards.items() for k in keys}}
        (tmp_path / "model.safetensors.index.json").write_text(
            json.dumps(index))
    else:
        st_torch.save_file(sd, str(tmp_path / "model.safetensors"))
    got = thf.load_state_dict(str(tmp_path))
    want = jhf.load_state_dict(str(tmp_path))
    assert set(got) == set(want) == set(sd)
    for k in sd:
        assert got[k].dtype == np.float32 and got[k].shape == tuple(
            sd[k].shape)
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        np.testing.assert_array_equal(got[k], sd[k].float().numpy())
    if dtype != torch.bfloat16:
        from safetensors.numpy import load_file
        files = sorted(tmp_path.glob("*.safetensors"))
        direct = {k: v for f in files for k, v in load_file(str(f)).items()}
        for k in sd:
            np.testing.assert_array_equal(got[k], direct[k].astype(
                np.float32))
    one = thf.load_state_dict(str(sorted(tmp_path.glob("*.safetensors"))[0]))
    assert set(one) <= set(sd)


def test_load_state_dict_bin_and_missing(tmp_path):
    """``pytorch_model.bin`` through torch.load (weights only), as f32;
    a directory without a checkpoint raises FileNotFoundError."""
    sd = {k: v.to(torch.float16) for k, v in _tensors(1).items()}
    torch.save(sd, tmp_path / "pytorch_model.bin")
    got = thf.load_state_dict(str(tmp_path))
    want = jhf.load_state_dict(str(tmp_path))
    for k in sd:
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k])
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(FileNotFoundError, match="no checkpoint found"):
        thf.load_state_dict(str(empty))


def test_read_safetensors_refuses_other_dtypes(tmp_path):
    st_torch = pytest.importorskip("safetensors.torch")
    st_torch.save_file({"i": torch.arange(4, dtype=torch.int32)},
                       str(tmp_path / "x.safetensors"))
    with pytest.raises(ValueError, match="I32"):
        thf.read_safetensors(str(tmp_path / "x.safetensors"))


# ---- converters -------------------------------------------------------------


@pytest.mark.parametrize("name", list(GEOMETRY))
def test_converters_match_jax(name):
    """Each converter (OPT pre-norm, OPT post-norm with projections,
    BLOOM's per-head q/k/v split, Llama with GQA, Qwen's q/k/v biases) on
    a random state dict: the JAX package's tree, leaf by leaf and bit for
    bit, with (in, out) kernels as init_params builds them; the family
    found from the model name."""
    jcfg, tcfg = _cfgs(name)
    fam = FAMILY[name]
    sd = hf_state_dict(fam, tcfg, seed=3)
    want = jhf._CONVERTERS[fam](jcfg, sd)
    got = thf._CONVERTERS[fam](tcfg, sd, device="cpu")
    assert_trees_equal(got, want)
    model = {"opt": "opt-1.3b", "bloom": "bigscience/bloom-560m",
             "llama": "Llama-3-8B", "qwen": "Qwen2-7B"}[fam]
    assert thf.family_of(model) == jhf.family_of(model) == fam
    with pytest.raises(ValueError, match="family"):
        thf.family_of("gpt2")


def test_load_hf_checkpoint_matches_jax(tmp_path):
    """load_hf_checkpoint on a safetensors OPT checkpoint: the JAX
    package's tree, bit for bit."""
    st_np = pytest.importorskip("safetensors.numpy")
    jcfg, tcfg = _cfgs("opt")
    sd = hf_state_dict("opt", tcfg, seed=5)
    st_np.save_file(sd, str(tmp_path / "model.safetensors"))
    got = thf.load_hf_checkpoint(tcfg, "opt-tiny", str(tmp_path),
                                 device="cpu")
    assert_trees_equal(got, jhf.load_hf_checkpoint(jcfg, "opt-tiny",
                                                   str(tmp_path)))
    assert got["layers"][0]["attn"]["q"]["kernel"].is_contiguous()


# ---- HF logit parity --------------------------------------------------------


def _hf_model(name):
    # The PyTorch models only: importing TensorFlow beside them would add
    # seconds and nothing to check.
    os.environ.setdefault("USE_TF", "0")
    transformers = pytest.importorskip("transformers")
    g = GEOMETRY[name]
    if name.startswith("opt"):
        hf_cfg = transformers.OPTConfig(
            vocab_size=g["vocab_size"], hidden_size=32, num_hidden_layers=2,
            num_attention_heads=4, ffn_dim=64, max_position_embeddings=64,
            do_layer_norm_before=g.get("pre_norm", True),
            word_embed_proj_dim=g.get("embed_dim", 32),
            activation_function="relu")
        return transformers.OPTForCausalLM(hf_cfg).eval()
    if name == "bloom":
        return transformers.BloomForCausalLM(transformers.BloomConfig(
            vocab_size=101, hidden_size=32, n_layer=2, n_head=4)).eval()
    return transformers.LlamaForCausalLM(transformers.LlamaConfig(
        vocab_size=103, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, intermediate_size=64,
        max_position_embeddings=64, rope_theta=10000.0)).eval()


@pytest.mark.parametrize("name", ["opt", "opt_post", "bloom", "llama"])
def test_hf_logit_parity(name):
    """The HF model's state dict converted by the port: its forward's
    logits within 2e-3 of the HF model's largest logit (the JAX test's
    bound) and of JAX's forward on the JAX converter's tree."""
    torch.manual_seed(0)
    hf = _hf_model(name)
    jcfg, tcfg = _cfgs(name)
    sd = {k: v.to(torch.float32).numpy() for k, v in hf.state_dict().items()}
    fam = FAMILY[name]
    params = thf._CONVERTERS[fam](tcfg, sd, device="cpu")
    tokens = np.random.RandomState(0).randint(
        0, tcfg.vocab_size, (2, 12)).astype(np.int32)
    with torch.no_grad():
        ref = hf(torch.tensor(tokens, dtype=torch.long)).logits.numpy()
    got = tforward(tcfg, params, torch.from_numpy(tokens)).numpy()
    jgot = np.asarray(jforward(jcfg, jhf._CONVERTERS[fam](jcfg, sd),
                               jnp.asarray(tokens)))
    assert got.shape == ref.shape == jgot.shape
    scale = np.abs(ref).max() + 1e-6
    assert np.abs(got - ref).max() / scale < 2e-3
    assert np.abs(got - jgot).max() / scale < 2e-3
