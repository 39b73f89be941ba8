"""HuggingFace checkpoint conversion: local state dicts -> the port's param
tree (port of ``sleekit_tpu/models/hf.py``).

Covers OPT (pre-norm, and OPT-350m's post-norm with ``project_in`` /
``project_out``), BLOOM (its fused query_key_value split per head), Llama
and the Qwen alias. Keys are mapped from the public HF implementations;
``"kernel"`` is (in, out), as :func:`~sleekit_tpu_torch.models.transformer.
init_params` builds it.

:func:`load_state_dict` reads single or sharded ``.safetensors`` files
itself (an 8-byte little-endian header length, a JSON header, then raw
little-endian buffers: F32, F16 and BF16), so no ``safetensors`` package
is needed, and ``pytorch_model.bin`` through ``torch.load``. It returns
f32 numpy arrays, as the JAX package's does.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict

import numpy as np
import torch

from sleekit_tpu_torch.device import resolve_device
from sleekit_tpu_torch.models.transformer import TransformerConfig

_SAFETENSORS_DTYPES = {"F32": np.float32, "F16": np.float16,
                       "BF16": np.uint16}


def read_safetensors(path: str) -> Dict[str, np.ndarray]:
    """One ``.safetensors`` file as f32 numpy arrays (F32, F16 or BF16
    tensors; BF16 widened through its ``uint16`` bits)."""
    with open(path, "rb") as f:
        (n,) = np.frombuffer(f.read(8), "<u8")
        header = json.loads(f.read(int(n)))
    base = 8 + int(n)
    raw = np.memmap(path, dtype=np.uint8, mode="r")
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dt = _SAFETENSORS_DTYPES.get(info["dtype"])
        if dt is None:
            raise ValueError(f"{path}: tensor {name} has dtype "
                             f"{info['dtype']}; F32, F16 and BF16 are read")
        begin, end = info["data_offsets"]
        a = raw[base + begin:base + end].view(np.dtype(dt).newbyteorder("<"))
        if info["dtype"] == "BF16":
            a = (a.astype(np.uint32) << 16).view(np.float32)
        out[name] = a.astype(np.float32).reshape(info["shape"])
    del raw
    return out


def load_state_dict(path: str) -> Dict[str, np.ndarray]:
    """Load a checkpoint directory or file into f32 numpy arrays.

    Supports single/sharded .safetensors and pytorch_model.bin layouts.
    """
    if os.path.isfile(path):
        files = [path]
    else:
        index = os.path.join(path, "model.safetensors.index.json")
        if os.path.exists(index):
            with open(index) as f:
                shards = sorted(set(json.load(f)["weight_map"].values()))
            files = [os.path.join(path, s) for s in shards]
        elif os.path.exists(os.path.join(path, "model.safetensors")):
            files = [os.path.join(path, "model.safetensors")]
        elif os.path.exists(os.path.join(path, "pytorch_model.bin")):
            files = [os.path.join(path, "pytorch_model.bin")]
        else:
            raise FileNotFoundError(f"no checkpoint found under {path}")

    sd: Dict[str, np.ndarray] = {}
    for f in files:
        if f.endswith(".safetensors"):
            sd.update(read_safetensors(f))
        else:
            raw = torch.load(f, map_location="cpu", weights_only=True)
            sd.update({k: v.to(torch.float32).numpy() for k, v in raw.items()})
    return sd


def _t(a: np.ndarray, dev, transpose: bool = False) -> torch.Tensor:
    """A f32 tensor on ``dev`` (transposed there, contiguous)."""
    x = torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)
    return x.T.contiguous() if transpose else x


def _lin(sd, prefix, dev):
    p = {"kernel": _t(sd[prefix + ".weight"], dev, transpose=True)}
    if prefix + ".bias" in sd:
        p["bias"] = _t(sd[prefix + ".bias"], dev)
    return p


def _norm(sd, prefix, dev):
    p = {"scale": _t(sd[prefix + ".weight"], dev)}
    if prefix + ".bias" in sd:
        p["bias"] = _t(sd[prefix + ".bias"], dev)
    return p


def convert_opt(cfg: TransformerConfig, sd: Dict[str, np.ndarray],
                device="cuda"):
    """facebook/opt-* (HF OPTForCausalLM state dict)."""
    dev = resolve_device(device)
    pre = "model.decoder."
    params: Dict[str, Any] = {"embed": {
        "tokens": _t(sd[pre + "embed_tokens.weight"], dev),
        "pos": _t(sd[pre + "embed_positions.weight"], dev),
    }}
    if pre + "project_in.weight" in sd:
        params["embed"]["project_in"] = _lin(sd, pre + "project_in", dev)
        params["embed"]["project_out"] = _lin(sd, pre + "project_out", dev)
    layers = []
    for i in range(cfg.n_layers):
        lp = f"{pre}layers.{i}."
        layers.append({
            "ln1": _norm(sd, lp + "self_attn_layer_norm", dev),
            "ln2": _norm(sd, lp + "final_layer_norm", dev),
            "attn": {
                "q": _lin(sd, lp + "self_attn.q_proj", dev),
                "k": _lin(sd, lp + "self_attn.k_proj", dev),
                "v": _lin(sd, lp + "self_attn.v_proj", dev),
                "o": _lin(sd, lp + "self_attn.out_proj", dev),
            },
            "mlp": {
                "fc1": _lin(sd, lp + "fc1", dev),
                "fc2": _lin(sd, lp + "fc2", dev),
            },
        })
    params["layers"] = layers
    if cfg.final_ln:
        params["final_ln"] = _norm(sd, pre + "final_layer_norm", dev)
    return params


def convert_bloom(cfg: TransformerConfig, sd: Dict[str, np.ndarray],
                  device="cuda"):
    """bigscience/bloom-* (HF BloomForCausalLM state dict).

    The fused query_key_value weight interleaves q/k/v per head
    ((n_head, 3, head_dim) row blocks); split into separate q/k/v.
    """
    dev = resolve_device(device)
    pre = "transformer."
    d, nh, hd = cfg.d_model, cfg.n_heads, cfg.head_dim
    params: Dict[str, Any] = {"embed": {
        "tokens": _t(sd[pre + "word_embeddings.weight"], dev),
        "ln": _norm(sd, pre + "word_embeddings_layernorm", dev),
    }}
    layers = []
    for i in range(cfg.n_layers):
        lp = f"{pre}h.{i}."
        w = sd[lp + "self_attention.query_key_value.weight"].reshape(
            nh, 3, hd, d)
        b = sd[lp + "self_attention.query_key_value.bias"].reshape(nh, 3, hd)

        def split(j, w=w, b=b):
            return {"kernel": _t(w[:, j].reshape(nh * hd, d), dev,
                                 transpose=True),
                    "bias": _t(b[:, j].reshape(nh * hd), dev)}

        layers.append({
            "ln1": _norm(sd, lp + "input_layernorm", dev),
            "ln2": _norm(sd, lp + "post_attention_layernorm", dev),
            "attn": {
                "q": split(0), "k": split(1), "v": split(2),
                "o": _lin(sd, lp + "self_attention.dense", dev),
            },
            "mlp": {
                "fc1": _lin(sd, lp + "mlp.dense_h_to_4h", dev),
                "fc2": _lin(sd, lp + "mlp.dense_4h_to_h", dev),
            },
        })
    params["layers"] = layers
    params["final_ln"] = _norm(sd, pre + "ln_f", dev)
    return params


def convert_llama(cfg: TransformerConfig, sd: Dict[str, np.ndarray],
                  device="cuda"):
    """meta-llama/Llama-* (HF LlamaForCausalLM state dict)."""
    dev = resolve_device(device)
    pre = "model."
    params: Dict[str, Any] = {"embed": {
        "tokens": _t(sd[pre + "embed_tokens.weight"], dev),
    }}
    layers = []
    for i in range(cfg.n_layers):
        lp = f"{pre}layers.{i}."
        layers.append({
            "ln1": {"scale": _t(sd[lp + "input_layernorm.weight"], dev)},
            "ln2": {"scale": _t(sd[lp + "post_attention_layernorm.weight"],
                                dev)},
            "attn": {
                "q": _lin(sd, lp + "self_attn.q_proj", dev),
                "k": _lin(sd, lp + "self_attn.k_proj", dev),
                "v": _lin(sd, lp + "self_attn.v_proj", dev),
                "o": _lin(sd, lp + "self_attn.o_proj", dev),
            },
            "mlp": {
                "gate": _lin(sd, lp + "mlp.gate_proj", dev),
                "up": _lin(sd, lp + "mlp.up_proj", dev),
                "down": _lin(sd, lp + "mlp.down_proj", dev),
            },
        })
    params["layers"] = layers
    params["final_ln"] = {"scale": _t(sd[pre + "norm.weight"], dev)}
    if "lm_head.weight" in sd:
        params["lm_head"] = {"kernel": _t(sd["lm_head.weight"], dev,
                                          transpose=True)}
    return params


_CONVERTERS = {
    "opt": convert_opt,
    "bloom": convert_bloom,
    "llama": convert_llama,
    # Qwen2ForCausalLM uses the llama module naming (model.layers.i.
    # self_attn.q_proj, ...); its q/k/v biases ride through _lin.
    "qwen": convert_llama,
}


def family_of(model_name: str) -> str:
    for fam in _CONVERTERS:
        if fam in model_name.lower():
            return fam
    raise ValueError(f"cannot infer model family from {model_name!r}")


def load_hf_checkpoint(cfg: TransformerConfig, model_name: str, path: str,
                       device="cuda"):
    """Convert a local HF checkpoint into the port's param tree (f32), on
    the CUDA device unless ``device`` says otherwise."""
    dev = resolve_device(device)
    fam = family_of(model_name)
    sd = load_state_dict(path)
    return _CONVERTERS[fam](cfg, sd, device=dev)
