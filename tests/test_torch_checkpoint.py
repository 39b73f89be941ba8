"""skq1/skq2 checkpoints are shared with the JAX package: one written by
either package loads in the other with identical arrays (mirrors
tests/test_checkpoint.py:18,32,43)."""

import json

import numpy as np
import jax
import pytest
import torch

from sleekit_tpu.codebooks import Codebook as JCodebook
from sleekit_tpu.codebooks import UniformCodebook as JUniform
from sleekit_tpu.models import transformer as jtr
from sleekit_tpu.models.fake_quant import random_packed_params as j_random
from sleekit_tpu.models.quantize import pack_lm_head as j_pack_head
from sleekit_tpu.models.zoo import tiny_test as j_tiny
from sleekit_tpu.ops.pack import PackedLinear as JPackedLinear
from sleekit_tpu.serve import checkpoint as jckpt
from sleekit_tpu_torch.codebooks import UniformCodebook
from sleekit_tpu_torch.convert import params_from_numpy
from sleekit_tpu_torch.models import transformer as ttr
from sleekit_tpu_torch.models.fake_quant import random_packed_params
from sleekit_tpu_torch.models.quantize import pack_lm_head
from sleekit_tpu_torch.models.zoo import tiny_test
from sleekit_tpu_torch.ops.pack import PackedLinear
from sleekit_tpu_torch.serve import checkpoint as tckpt

from tests._torch_port_util import to_numpy_tree

GEO = dict(d_model=512, d_ff=1024, n_heads=4)


def _leaves(tree):
    """(path, value) of every array and PackedLinear field, sorted."""
    out = []

    def walk(node, path):
        if isinstance(node, (PackedLinear, JPackedLinear)):
            for f in ("packed", "scale", "lut", "bias"):
                walk(getattr(node, f), f"{path}/{f}")
            out.append((f"{path}/meta", (
                node.in_features, node.out_features, node.nbits,
                None if node.affine is None else tuple(node.affine),
                node.layout, node.k_splits)))
        elif isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], f"{path}/{k}")
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{path}/{i}")
        elif node is not None:
            bf16 = (isinstance(node, torch.Tensor)
                    and node.dtype == torch.bfloat16)
            a = node.view(torch.int16).numpy() if bf16 else np.asarray(node)
            out.append((path, a))
    walk(tree, "")
    return out


def _assert_same(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        if path.endswith("/meta"):
            assert x == y, path
        else:
            assert x.dtype == y.dtype and x.shape == y.shape, path
            np.testing.assert_array_equal(x, y, err_msg=path)


@pytest.mark.parametrize("layout", ["pair3x", "plane"])
@pytest.mark.parametrize("stacked", [False, True])
def test_jax_checkpoint_loads_in_port(tmp_path, layout, stacked):
    """A JAX-written skq2 tree ('pair3x' int3, or NF4 'plane'; int8 head;
    f32 dense leaves; per-layer or stacked scan_layers) loads in the port:
    the same arrays as params_from_numpy gives, and bit-identical logits.
    A stacked tree takes its layer count from the leaves without cfg."""
    jcfg = j_tiny(scan_layers=stacked, **GEO)
    tcfg = tiny_test(**GEO)
    cb = JUniform(8, -1.0, 1.0) if layout == "pair3x" else JCodebook.nf4()
    jp, _ = j_random(jcfg, jax.random.PRNGKey(1), cb, fuse_qkv=True,
                     layout=layout)
    jp = j_pack_head(jcfg, jp)
    jckpt.save_packed_params(str(tmp_path), jp, meta={"nbits": 3})
    got, meta = tckpt.load_packed_params(
        str(tmp_path), None if stacked else tcfg, device="cpu")
    assert meta == {"nbits": 3}
    want = params_from_numpy(tcfg, to_numpy_tree(jp), device="cpu")
    assert len(got["layers"]) == tcfg.n_layers
    assert got["layers"][0]["attn"]["qkv"].layout == layout
    _assert_same(got, want)
    tokens = torch.from_numpy(
        np.random.RandomState(2).randint(0, 256, (2, 9)))
    assert torch.equal(ttr.forward(tcfg, got, tokens),
                       ttr.forward(tcfg, want, tokens))


def test_port_checkpoint_loads_in_jax(tmp_path):
    """A port-written skq2 tree (int3 'pair3x' with an int8 head, f32
    dense leaves) loads in the JAX package with identical arrays and
    metadata."""
    tcfg = tiny_test(**GEO)
    params, _ = random_packed_params(
        tcfg, 0, codebook=UniformCodebook(8, -1.0, 1.0), fuse_qkv=True,
        layout="pair3x", device="cpu")
    params = pack_lm_head(tcfg, params)
    tckpt.save_packed_params(str(tmp_path), params, meta={"model": "tiny"})
    loaded, meta = jckpt.load_packed_params(str(tmp_path))
    assert meta == {"model": "tiny"}
    _assert_same(loaded, params)


def test_bf16_leaves_round_trip(tmp_path):
    """bf16 dense leaves: the port writes them as numpy's 2-byte void
    ('|V2', as an .npz holds the JAX package's bf16 arrays) and reads them
    back bit for bit; a JAX-written bf16 tree loads in the port too."""
    tcfg = tiny_test(dtype=torch.bfloat16, **GEO)
    params, _ = random_packed_params(tcfg, 0, fuse_qkv=True, device="cpu")
    assert params["embed"]["tokens"].dtype == torch.bfloat16
    tckpt.save_packed_params(str(tmp_path / "port"), params)
    with np.load(tmp_path / "port" / "tensors.npz") as npz:
        assert any(npz[k].dtype == np.dtype("V2") for k in npz.files)
    loaded, _ = tckpt.load_packed_params(str(tmp_path / "port"), tcfg,
                                         device="cpu")
    _assert_same(loaded, params)

    jcfg = j_tiny(dtype=jax.numpy.bfloat16, n_layers=1, **GEO)
    jp = jtr.init_params(jcfg, jax.random.PRNGKey(0))
    jckpt.save_packed_params(str(tmp_path / "jax"), jp)
    got, _ = tckpt.load_packed_params(str(tmp_path / "jax"), device="cpu")
    want = params_from_numpy(None, to_numpy_tree(jp), device="cpu")
    assert got["embed"]["tokens"].dtype == torch.bfloat16
    _assert_same(got, want)


def test_unknown_format_rejected(tmp_path):
    tckpt.save_packed_params(str(tmp_path), {"w": torch.ones(3)})
    manifest = json.loads((tmp_path / "manifest.json").read_text())
    assert manifest["format"] == "skq2"
    loaded, _ = tckpt.load_packed_params(str(tmp_path), device="cpu")
    assert torch.equal(loaded["w"], torch.ones(3))
    manifest["format"] = "skq9"
    (tmp_path / "manifest.json").write_text(json.dumps(manifest))
    with pytest.raises(ValueError, match="skq9"):
        tckpt.load_packed_params(str(tmp_path), device="cpu")
