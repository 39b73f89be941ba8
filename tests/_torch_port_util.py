"""Shared helpers of the port's tests: carry JAX values over to the port
through numpy (bf16 included)."""

import contextlib
import dataclasses
import io

import numpy as np
import pytest
import torch


def to_numpy_tree(tree):
    """A JAX params tree as the numpy tree ``params_from_numpy`` takes:
    arrays become numpy arrays, each PackedLinear a dict of its fields."""
    from sleekit_tpu.ops.pack import PackedLinear

    if isinstance(tree, PackedLinear):
        out = {f.name: getattr(tree, f.name)
               for f in dataclasses.fields(tree) if f.name != "layer_sel"}
        for key in ("packed", "scale", "lut", "bias"):
            if out[key] is not None:
                out[key] = np.asarray(out[key])
        return out
    if isinstance(tree, dict):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_numpy_tree(v) for v in tree]
    return np.asarray(tree)


def t(a, dtype=None) -> torch.Tensor:
    """numpy or JAX array -> CPU tensor (bf16 kept bit for bit)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        out = torch.from_numpy(a.view(np.uint16).view(np.int16).copy()).view(
            torch.bfloat16)
    else:
        out = torch.from_numpy(np.array(a))
    return out if dtype is None else out.to(dtype)


def f32(x) -> np.ndarray:
    """Tensor or JAX array -> f32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def bf16_close(got, ref, what=""):
    """The kernels' bf16 tolerance: rtol 2^-6 and atol 1e-2*max|ref|.
    Both sides round pre(x) and the output to bf16 (2^-8 relative each)
    and sum in another order."""
    got, ref = f32(got), f32(ref)
    np.testing.assert_allclose(got, ref, rtol=2 ** -6,
                               atol=1e-2 * np.abs(ref).max(), err_msg=what)


def quant_problem(m, n, seed, rank=None, mean=0.3):
    """A quantizer test problem from numpy's seed: W (m, n) standard
    normal and a Hessian H = XᵀX / s from s samples of mean ``mean`` (s =
    ``rank`` if given, else 2n)."""
    rng = np.random.default_rng(seed)
    W = rng.standard_normal((m, n)).astype(np.float32)
    s = rank or 2 * n
    X = (rng.standard_normal((s, n)) + mean).astype(np.float32)
    return W, (X.T @ X / s).astype(np.float32)


def same_codewords(got, want, cb, what=""):
    """Quantized weights on the same codewords (equal codebook indices)
    with values within 1e-6 of the largest: XLA computes a uniform
    codebook's value as a fused multiply-add, one f32 step from
    PyTorch's."""
    got = torch.as_tensor(got)
    want = torch.from_numpy(np.array(want, np.float32))
    np.testing.assert_array_equal(cb.quantize_index(got).numpy(),
                                  cb.quantize_index(want).numpy(),
                                  err_msg=what)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=1e-6 * float(want.abs().max()),
                               err_msg=what)


def tf32_rna(v):
    """``v`` rounded to TF32 (10 mantissa bits) to nearest, ties away from
    zero, as f32: what ``cvt.rna.tf32.f32`` gives."""
    bits = np.ascontiguousarray(v, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def tf32_trunc(v):
    """The top 19 bits of f32 ``v`` (the TF32 value the tensor cores read
    from an f32 operand), as f32."""
    bits = np.ascontiguousarray(v, dtype=np.float32).view(np.uint32)
    return (bits & np.uint32(0xFFFFE000)).view(np.float32)


def tf32_mma(c, prods):
    """One tensor-core sum as an H100 forms it (tests/test_torch_cuda.py
    test_tf32_mma_truncates): the accumulator c (f32, any shape) and the
    exact products (c's shape + (8,)), aligned to the largest, each
    truncated 25 bits below it, summed, and the sum truncated to f32."""
    terms = np.concatenate([np.asarray(c, np.float64)[..., None], prods],
                           axis=-1)
    top = np.abs(terms).max(axis=-1)
    e = np.floor(np.log2(np.where(top > 0, top, 1.0)))
    q = np.exp2(e - 25)[..., None]
    total = (np.trunc(terms / q) * q).sum(axis=-1)
    f = np.asarray(total.astype(np.float32))
    over = np.abs(f.astype(np.float64)) > np.abs(total)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


@pytest.fixture(scope="module")
def one_torch_thread():
    """One intra-op thread for a module of many small tensor ops (the
    quantizer's loops): the suite runs several test processes at once,
    and a thread pool per process each op only adds contention."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def hf_state_dict(family: str, cfg, seed: int = 0):
    """A random HF-layout state dict (f32 numpy, weights (out, in)) of
    ``cfg`` from numpy's seed, under the key names that the converters
    read: 'opt' (with ``project_in``/``project_out`` when ``embed_dim``
    differs from ``d_model``), 'bloom' (fused query_key_value), 'llama'
    (``lm_head`` unless tied) and 'qwen' (llama's with q/k/v biases)."""
    rng = np.random.default_rng(seed)
    sd = {}

    def add(key, *shape):
        sd[key] = (rng.standard_normal(shape) * 0.1).astype(np.float32)

    def lin(prefix, n_out, n_in, bias=True):
        add(prefix + ".weight", n_out, n_in)
        if bias:
            add(prefix + ".bias", n_out)

    def norm(prefix, bias=True):
        sd[prefix + ".weight"] = (1.0 + rng.standard_normal(
            cfg.d_model) * 0.1).astype(np.float32)
        if bias:
            add(prefix + ".bias", cfg.d_model)

    d, ff, v = cfg.d_model, cfg.d_ff, cfg.vocab_size
    kv = cfg.kv_heads * cfg.head_dim
    if family == "opt":
        pre = "model.decoder."
        ed = cfg.embed_dim or d
        add(pre + "embed_tokens.weight", v, ed)
        add(pre + "embed_positions.weight", cfg.max_seq_len + 2, d)
        if ed != d:
            lin(pre + "project_in", d, ed, bias=False)
            lin(pre + "project_out", ed, d, bias=False)
        for i in range(cfg.n_layers):
            lp = f"{pre}layers.{i}."
            for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
                lin(lp + "self_attn." + n, d, d)
            norm(lp + "self_attn_layer_norm")
            norm(lp + "final_layer_norm")
            lin(lp + "fc1", ff, d)
            lin(lp + "fc2", d, ff)
        if cfg.final_ln:
            norm(pre + "final_layer_norm")
    elif family == "bloom":
        pre = "transformer."
        add(pre + "word_embeddings.weight", v, d)
        norm(pre + "word_embeddings_layernorm")
        for i in range(cfg.n_layers):
            lp = f"{pre}h.{i}."
            norm(lp + "input_layernorm")
            norm(lp + "post_attention_layernorm")
            lin(lp + "self_attention.query_key_value", 3 * d, d)
            lin(lp + "self_attention.dense", d, d)
            lin(lp + "mlp.dense_h_to_4h", ff, d)
            lin(lp + "mlp.dense_4h_to_h", d, ff)
        norm(pre + "ln_f")
    elif family in ("llama", "qwen"):
        pre = "model."
        qb = family == "qwen"
        add(pre + "embed_tokens.weight", v, d)
        for i in range(cfg.n_layers):
            lp = f"{pre}layers.{i}."
            norm(lp + "input_layernorm", bias=False)
            norm(lp + "post_attention_layernorm", bias=False)
            lin(lp + "self_attn.q_proj", d, d, bias=qb)
            lin(lp + "self_attn.k_proj", kv, d, bias=qb)
            lin(lp + "self_attn.v_proj", kv, d, bias=qb)
            lin(lp + "self_attn.o_proj", d, d, bias=False)
            lin(lp + "mlp.gate_proj", ff, d, bias=False)
            lin(lp + "mlp.up_proj", ff, d, bias=False)
            lin(lp + "mlp.down_proj", d, ff, bias=False)
        norm(pre + "norm", bias=False)
        if not cfg.tie_embeddings:
            add("lm_head.weight", v, d)
    else:
        raise ValueError(family)
    return sd


def assert_trees_equal(got, want, path=""):
    """A port params tree (tensors) equal, leaf by leaf and bit for bit,
    to a JAX one of the same structure."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            assert_trees_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_trees_equal(g, w, f"{path}/{i}")
    else:
        w = np.asarray(want)
        g = got.detach().cpu().numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, path
        np.testing.assert_array_equal(g, w, err_msg=path)


# A tiny OPT under a name with "opt" in it (the HF converter's family comes
# from the name), for the commands' tests.
TINY_OPT = "tiny-opt"


@contextlib.contextmanager
def tiny_opt_checkpoint(root):
    """``TINY_OPT`` registered in both packages' zoos (as ``tiny_test``)
    for the block, and its HF checkpoint (random weights, numpy seed 7)
    written with ``safetensors`` to ``root / "hf"``."""
    st_np = pytest.importorskip("safetensors.numpy")
    from sleekit_tpu.models import zoo as jzoo
    from sleekit_tpu_torch.models import zoo as tzoo

    mp = pytest.MonkeyPatch()
    mp.setitem(jzoo.ZOO, TINY_OPT, jzoo.tiny_test)
    mp.setitem(tzoo.ZOO, TINY_OPT, tzoo.tiny_test)
    try:
        (root / "hf").mkdir()
        st_np.save_file(hf_state_dict("opt", tzoo.tiny_test(), seed=7),
                        str(root / "hf" / "model.safetensors"))
        yield root / "hf"
    finally:
        mp.undo()


def run_main(main, argv):
    """(stdout, result) of a command's ``main(argv)``."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = main(argv)
    return buf.getvalue(), result
