"""Decoder-only transformer for serving (port of the serving half of
``sleekit_tpu/models/transformer.py``).

Params are nested dicts of tensors; a quantized linear is a
:class:`~sleekit_tpu_torch.ops.pack.PackedLinear`, per layer in a Python
list. The KV cache is a stacked dict, because the kernels take a layer
index: the slot cache (L, B, KV, S, D), or for decode the page pool
(L, P, KV, PS, D) with its page table; it is updated IN PLACE by prefill
and decode. ``lax.scan`` over layers and decode steps becomes a Python loop.

The packed bf16 projections go through K1/K2 (with the norm, activation
and residual fused when M <= 1024), decode attention through K3 (K5 over a
page pool; K10/K11 or K14/K15 on the split route), the prefill's KV write
through K10 over the prompt's rows, and 128-aligned prefill of >= 256
tokens through K4, as the JAX package routes them to its Pallas kernels
(and the KV write to XLA) on the TPU. ``use_kernel`` (default: the tokens
are on CUDA) launches the kernels; ``use_kernel=False`` runs their plain
PyTorch versions instead, on any device. Everything else (f32
activations, dense weights, short prompts' attention) is PyTorch code.

Calibration: ``forward(..., stats=...)`` and :func:`calibrate_step`
fold each quantizable linear's input into its ``LayerStats`` (the
per-linear Hessian statistics of ``hessian.py``) as the forward reaches
it, on the activations' device. With statistics, a block runs its
output and MLP projections unfused (``x + o(attn)``, then fc1, the
activation and fc2), as the JAX package does.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from sleekit_tpu_torch.device import resolve_device
from sleekit_tpu_torch.hessian import LayerStats, init_stats, update_stats
from sleekit_tpu_torch.ops.attention import (
    decode_attention, flash_prefill, flash_prefill_plain, kv_prefill_write,
    kv_prefill_write_plain)
from sleekit_tpu_torch.ops.dequant_matmul import (
    can_fuse_glue, fused_quantized_matmul, quantized_matmul)
from sleekit_tpu_torch.ops.pack import PackedLinear, concat_packed
from sleekit_tpu_torch.ops.paged_attention import paged_decode_attention


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 50272
    d_model: int = 768
    n_layers: int = 12
    n_heads: int = 12
    n_kv_heads: Optional[int] = None      # GQA; None -> n_heads
    d_ff: int = 3072
    max_seq_len: int = 2048
    activation: str = "relu"              # relu | gelu | silu_glu (SwiGLU)
    norm: str = "layernorm"               # layernorm | rmsnorm
    positional: str = "learned"           # learned | alibi | rope
    pre_norm: bool = True
    learned_pos_offset: int = 2           # OPT offsets positions by 2
    embed_ln: bool = False                # BLOOM: layernorm after embedding
    final_ln: bool = True
    tie_embeddings: bool = True
    embed_dim: Optional[int] = None       # OPT-350M word_embed_proj_dim
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    qkv_bias: bool = False
    dtype: Any = torch.float32

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


# ---- parameter initialization ---------------------------------------------


def init_params(cfg: TransformerConfig, seed: int = 0, device="cuda",
                linear_factory=None) -> Dict[str, Any]:
    """Random-init parameters from a numpy seed, built on the host and
    moved to ``device``. ``linear_factory(d_in, d_out, bias)`` overrides
    how the quantizable linears are built (fake_quant builds packed ones
    directly)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    dtype = cfg.dtype
    d = cfg.d_model
    ed = cfg.embed_dim or d
    use_bias = cfg.norm == "layernorm"  # llama-style models drop biases

    def normal(*shape):
        a = rng.standard_normal(shape, dtype=np.float32) * np.float32(0.02)
        return torch.from_numpy(a).to(device=dev, dtype=dtype)

    def zeros(n):
        return torch.zeros(n, dtype=dtype, device=dev)

    def dense(d_in, d_out, bias=True):
        p = {"kernel": normal(d_in, d_out)}
        if bias:
            p["bias"] = zeros(d_out)
        return p

    lin = linear_factory or dense

    def norm_p():
        p = {"scale": torch.ones(d, dtype=dtype, device=dev)}
        if cfg.norm == "layernorm":
            p["bias"] = zeros(d)
        return p

    params: Dict[str, Any] = {"embed": {"tokens": normal(cfg.vocab_size, ed)}}
    if cfg.positional == "learned":
        params["embed"]["pos"] = normal(
            cfg.max_seq_len + cfg.learned_pos_offset, d)
    if cfg.embed_ln:
        params["embed"]["ln"] = norm_p()
    if ed != d:
        params["embed"]["project_in"] = dense(ed, d, bias=False)
        params["embed"]["project_out"] = dense(d, ed, bias=False)
    kv_dim = cfg.kv_heads * cfg.head_dim
    qb = use_bias or cfg.qkv_bias
    layers: List[Dict[str, Any]] = []
    for _ in range(cfg.n_layers):
        layer = {
            "ln1": norm_p(), "ln2": norm_p(),
            "attn": {"q": lin(d, d, bias=qb), "k": lin(d, kv_dim, bias=qb),
                     "v": lin(d, kv_dim, bias=qb),
                     "o": lin(d, d, bias=use_bias)},
        }
        if cfg.activation == "silu_glu":
            layer["mlp"] = {"gate": lin(d, cfg.d_ff, bias=False),
                            "up": lin(d, cfg.d_ff, bias=False),
                            "down": lin(cfg.d_ff, d, bias=False)}
        else:
            layer["mlp"] = {"fc1": lin(d, cfg.d_ff, bias=use_bias),
                            "fc2": lin(cfg.d_ff, d, bias=use_bias)}
        layers.append(layer)
    params["layers"] = layers
    if cfg.final_ln:
        params["final_ln"] = norm_p()
    if not cfg.tie_embeddings:
        params["lm_head"] = dense(ed, cfg.vocab_size, bias=False)
    return params


# ---- primitive ops ----------------------------------------------------------


def apply_linear(p, x: torch.Tensor, use_kernel: bool = False,
                 stats: Optional[LayerStats] = None):
    """Dense dict ``{'kernel', 'bias'}`` or PackedLinear. With ``stats``,
    also folds the flattened input into them and returns (y, stats)."""
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    if stats is not None:
        stats = update_stats(stats, x2)
    if isinstance(p, PackedLinear):
        y2 = quantized_matmul(x2, p, use_kernel=use_kernel)
    else:
        y2 = (x2.float() @ p["kernel"].float()).to(x.dtype)
        if "bias" in p:
            y2 = y2 + p["bias"]
    y = y2.reshape(*shape[:-1], y2.shape[-1])
    return y if stats is None else (y, stats)


def apply_norm(cfg: TransformerConfig, p, x: torch.Tensor) -> torch.Tensor:
    x32 = x.float()
    if cfg.norm == "rmsnorm":
        var = (x32 * x32).mean(dim=-1, keepdim=True)
        return (x32 * torch.rsqrt(var + cfg.norm_eps) * p["scale"]).to(
            x.dtype)
    mean = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mean) * torch.rsqrt(var + cfg.norm_eps)
    return (y * p["scale"] + p["bias"]).to(x.dtype)


def _activation(cfg: TransformerConfig, x):
    if cfg.activation == "relu":
        return F.relu(x)
    if cfg.activation == "gelu":
        # jax.nn.gelu defaults to the tanh approximation.
        return F.gelu(x, approximate="tanh")
    raise ValueError(cfg.activation)


def _fused_proj(cfg, p, x, ln=None, act: Optional[str] = None,
                residual=None, use_kernel: bool = False):
    """``[residual +] proj(pre(x))`` in one K1/K2 launch where they take it
    (packed weights, bf16, M <= 1024); composed otherwise."""
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    if (isinstance(p, PackedLinear) and x2.shape[0] <= 1024
            and can_fuse_glue(x2, p)):
        r2 = (residual.reshape(-1, residual.shape[-1])
              if residual is not None else None)
        y2 = fused_quantized_matmul(
            x2, p, pre=(cfg.norm if ln is not None else act),
            ln_scale=None if ln is None else ln["scale"],
            ln_bias=None if ln is None else ln.get("bias"),
            eps=cfg.norm_eps, residual=r2, use_kernel=use_kernel)
        return y2.reshape(*shape[:-1], y2.shape[-1])
    if ln is not None:
        x = apply_norm(cfg, ln, x)
    if act == "silu_glu":
        dff = x.shape[-1] // 2
        x = F.silu(x[..., :dff]) * x[..., dff:]
    elif act is not None:
        x = _activation(cfg, x)
    y = apply_linear(p, x, use_kernel=use_kernel)
    if residual is not None:
        y = y + residual
    return y


def alibi_slopes(n_heads: int) -> np.ndarray:
    """BLOOM ALiBi head slopes (public formula from the ALiBi paper)."""
    def pow2_slopes(n):
        start = 2.0 ** (-(2.0 ** -(math.log2(n) - 3)))
        return [start * (start ** i) for i in range(n)]

    if math.log2(n_heads).is_integer():
        return np.asarray(pow2_slopes(n_heads), np.float32)
    closest = 2 ** math.floor(math.log2(n_heads))
    slopes = pow2_slopes(closest)
    extra = pow2_slopes(2 * closest)[0::2][: n_heads - closest]
    return np.asarray(slopes + extra, np.float32)


def rope_freqs(cfg: TransformerConfig, positions: torch.Tensor):
    """Rotary cos/sin tables for positions (B, T)."""
    hd = cfg.head_dim
    inv_freq = 1.0 / (cfg.rope_theta ** (
        torch.arange(0, hd, 2, dtype=torch.float32,
                     device=positions.device) / hd))
    angles = positions[..., None].float() * inv_freq
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x (B, T, H, hd); cos/sin (B, T, hd/2). Rotates in f32, returns
    x.dtype."""
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---- attention --------------------------------------------------------------


def _attention(cfg: TransformerConfig, q, k, v, bias):
    """q (B, T, H, hd); k, v (B, KV, S, hd); bias (1|B, H, T, S). Products
    in f32 of the input-dtype values; softmax in f32."""
    groups = cfg.n_heads // cfg.kv_heads
    if groups > 1:
        k = k.repeat_interleave(groups, dim=1)
        v = v.repeat_interleave(groups, dim=1)
    scale = 1.0 / math.sqrt(cfg.head_dim)
    logits = torch.einsum("bthd,bhsd->bhts", q.float(),
                          k.to(q.dtype).float()) * scale
    probs = torch.softmax(logits + bias, dim=-1)
    out = torch.einsum("bhts,bhsd->bthd", probs.to(q.dtype).float(),
                       v.to(q.dtype).float())
    return out.to(q.dtype)


def _causal_bias(cfg: TransformerConfig, q_pos, k_pos, slopes=None):
    """(1|B, H, T, S) additive bias: causal mask (+ ALiBi)."""
    mask = q_pos[..., :, None] >= k_pos[..., None, :]
    bias = torch.where(mask, 0.0, -1e9)
    bias = bias[None, None] if bias.ndim == 2 else bias[:, None]
    if slopes is not None:
        dist = (k_pos[..., None, :] - q_pos[..., :, None]).float()
        dist = dist[None, None] if dist.ndim == 2 else dist[:, None]
        bias = bias + slopes[None, :, None, None] * dist
    return bias


def _causal_attention(cfg: TransformerConfig, q, kT, vT, positions,
                      slopes=None, use_kernel: bool = False):
    """Causal self-attention from position 0: q (B, T, H, hd); kT, vT
    (B, KV, T, hd). 128-aligned T >= 256 goes to K4 (or its plain
    version), as the JAX package routes it to its flash prefill kernel."""
    T = q.shape[1]
    if T >= 256 and T % 128 == 0 and T == kT.shape[2]:
        fn = flash_prefill if use_kernel else flash_prefill_plain
        return fn(q.contiguous(), kT.contiguous(), vT.contiguous(),
                  1.0 / math.sqrt(cfg.head_dim), slopes)
    return _attention(cfg, q, kT, vT,
                      _causal_bias(cfg, positions, positions, slopes))


# ---- block + model forward --------------------------------------------------


def _attend(cfg, q, k, v, positions, kv, slopes, use_kernel: bool):
    """The attention of one block: q (B, T, H*hd), k and v (B, T, KV*hd)
    projections -> (B, T, H*hd), with RoPE, over ``kv`` as :func:`_block`
    takes it. ``cfg`` gives the heads (a tensor-parallel rank's local
    ones) and ``slopes`` their ALiBi slopes."""
    b, t, _ = q.shape
    q = q.reshape(b, t, cfg.n_heads, cfg.head_dim)
    k = k.reshape(b, t, cfg.kv_heads, cfg.head_dim)
    v = v.reshape(b, t, cfg.kv_heads, cfg.head_dim)
    if cfg.positional == "rope":
        cos, sin = rope_freqs(cfg, positions)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)

    if kv is None:
        attn = _causal_attention(cfg, q, k.transpose(1, 2), v.transpose(1, 2),
                                 positions, slopes, use_kernel)
    elif kv[0] == "decode":
        # A cache holding a "page_table" is a shared page pool
        # (ops/paged_attention.py); otherwise the slot cache.
        cache, pos, lidx = kv[1], kv[2], kv[3]
        step = (q[:, 0].contiguous(), k[:, 0].contiguous(),
                v[:, 0].contiguous(), cache["k"], cache["v"])
        common = dict(scale=1.0 / math.sqrt(cfg.head_dim),
                      alibi_slopes=slopes, k_scale=cache.get("k_scale"),
                      v_scale=cache.get("v_scale"), use_kernel=use_kernel)
        if "page_table" in cache:
            res = paged_decode_attention(*step, cache["page_table"], pos,
                                         lidx, **common)
        else:
            res = decode_attention(*step, pos, lidx, **common)
        attn = res[0][:, None]
    else:
        cache, lidx = kv[1], kv[2]
        write = kv_prefill_write if use_kernel else kv_prefill_write_plain
        attn_k, attn_v = write(k, v, cache["k"], cache["v"], lidx,
                               cache.get("k_scale"), cache.get("v_scale"))
        attn = _causal_attention(cfg, q, attn_k, attn_v, positions, slopes,
                                 use_kernel)
    return attn.reshape(b, t, cfg.n_heads * cfg.head_dim)


# Linear-layer names inside one block, in calibration order.
def block_linear_names(cfg: TransformerConfig) -> List[str]:
    if cfg.activation == "silu_glu":
        return ["q", "k", "v", "o", "gate", "up", "down"]
    return ["q", "k", "v", "o", "fc1", "fc2"]


def layer_names(cfg: TransformerConfig) -> List[str]:
    """Dotted names of every quantizable linear: ``layers.<i>.<name>``."""
    return [f"layers.{i}.{ln}" for i in range(cfg.n_layers)
            for ln in block_linear_names(cfg)]


def _linear_slot(params, name: str):
    i, ln = name.split(".")[1:]
    layer = params["layers"][int(i)]
    return layer["attn" if ln in ("q", "k", "v", "o") else "mlp"], ln


def get_linear_param(params, name: str):
    group, ln = _linear_slot(params, name)
    return group[ln]


def set_linear_param(params, name: str, value) -> None:
    """Replace one linear's params in place (params: plain dicts)."""
    group, ln = _linear_slot(params, name)
    group[ln] = value


def _block(cfg, layer, x, positions, kv, slopes, use_kernel: bool,
           stats: Optional[Dict[str, LayerStats]] = None,
           layer_idx: int = 0):
    """One transformer block. ``kv`` selects the attention path:
    * None - full-sequence forward (no cache);
    * ("prefill", cache, lidx) - write this layer's K/V for positions
      [0, T) into the stacked slot cache and attend them (int8 caches
      attend the dequantized cache values, as the JAX package does);
    * ("decode", cache, pos, lidx) - single-token decode: in-place append
      and attention over the slot cache or the page pool (K3 or K5 on the
      kernel path; K10 + K11 or K14 + K15 on the split route).
    The cache tensors are updated in place. ``stats`` (calibration): the
    statistics of this block's linears (``layers.<layer_idx>.<name>``),
    updated in the dict; its projections then run unfused."""

    def lin(name, p, h):
        key = f"layers.{layer_idx}.{name}"
        if stats is not None and key in stats:
            y, stats[key] = apply_linear(p, h, use_kernel, stats[key])
            return y
        return apply_linear(p, h, use_kernel)

    b, t, d = x.shape
    kv_dim = cfg.kv_heads * cfg.head_dim
    if "qkv" in layer["attn"]:
        qkv = _fused_proj(cfg, layer["attn"]["qkv"], x,
                          ln=layer["ln1"] if cfg.pre_norm else None,
                          use_kernel=use_kernel)
        q, k, v = qkv[..., :d], qkv[..., d:d + kv_dim], qkv[..., d + kv_dim:]
    else:
        h = apply_norm(cfg, layer["ln1"], x) if cfg.pre_norm else x
        q = lin("q", layer["attn"]["q"], h)
        k = lin("k", layer["attn"]["k"], h)
        v = lin("v", layer["attn"]["v"], h)
    attn = _attend(cfg, q, k, v, positions, kv, slopes, use_kernel)
    if stats is None:
        x = _fused_proj(cfg, layer["attn"]["o"], attn, residual=x,
                        use_kernel=use_kernel)
    else:
        x = x + lin("o", layer["attn"]["o"], attn)
    if not cfg.pre_norm:
        x = apply_norm(cfg, layer["ln1"], x)
    ln2 = layer["ln2"] if cfg.pre_norm else None
    if cfg.activation == "silu_glu":
        if "gate_up" in layer["mlp"]:
            gu = _fused_proj(cfg, layer["mlp"]["gate_up"], x, ln=ln2,
                             use_kernel=use_kernel)
            x = _fused_proj(cfg, layer["mlp"]["down"], gu, act="silu_glu",
                            residual=x, use_kernel=use_kernel)
        else:
            h = apply_norm(cfg, layer["ln2"], x) if cfg.pre_norm else x
            gate = lin("gate", layer["mlp"]["gate"], h)
            up = lin("up", layer["mlp"]["up"], h)
            x = x + lin("down", layer["mlp"]["down"], F.silu(gate) * up)
    elif stats is None:
        h = _fused_proj(cfg, layer["mlp"]["fc1"], x, ln=ln2,
                        use_kernel=use_kernel)
        x = _fused_proj(cfg, layer["mlp"]["fc2"], h, act=cfg.activation,
                        residual=x, use_kernel=use_kernel)
    else:
        h = apply_norm(cfg, layer["ln2"], x) if cfg.pre_norm else x
        h = _activation(cfg, lin("fc1", layer["mlp"]["fc1"], h))
        x = x + lin("fc2", layer["mlp"]["fc2"], h)
    if not cfg.pre_norm:
        x = apply_norm(cfg, layer["ln2"], x)
    return x


def _embed(cfg, params, tokens, positions, use_kernel: bool):
    emb = params["embed"]
    x = emb["tokens"][tokens.long()]
    if "project_in" in emb:
        x = apply_linear(emb["project_in"], x, use_kernel)
    if cfg.positional == "learned":
        x = x + emb["pos"][positions.long() + cfg.learned_pos_offset]
    if cfg.embed_ln:
        x = apply_norm(cfg, emb["ln"], x)
    return x


def _unembed(cfg, params, x, use_kernel: bool):
    if (cfg.final_ln and "lm_head" in params
            and "project_out" not in params["embed"]):
        # Packed serving head: the final norm rides the K2 prologue.
        return _fused_proj(cfg, params["lm_head"], x, ln=params["final_ln"],
                           use_kernel=use_kernel).float()
    if cfg.final_ln:
        x = apply_norm(cfg, params["final_ln"], x)
    if "project_out" in params["embed"]:
        x = apply_linear(params["embed"]["project_out"], x, use_kernel)
    if "lm_head" in params:
        return apply_linear(params["lm_head"], x, use_kernel).float()
    return x.float() @ params["embed"]["tokens"].float().T


def finalize_logits(cfg, logits):
    """The single owner of the padded-vocab contract: int8-layout heads pad
    N at pack time, so every consumer slices back to the true vocabulary
    here."""
    return logits[..., :cfg.vocab_size]


def unembed_logits(cfg, params, x, use_kernel: bool = False):
    return finalize_logits(cfg, _unembed(cfg, params, x, use_kernel))


def fuse_qkv_params(cfg: TransformerConfig, params):
    """Serving-time projection fusion: q|k|v -> 'qkv' (and gate|up ->
    'gate_up' for SwiGLU). Exact: per-output-channel scales concatenate."""

    def fuse(parts):
        if isinstance(parts[0], PackedLinear):
            return concat_packed(parts)
        kernel = torch.cat([p["kernel"] for p in parts], dim=1)
        out = {"kernel": kernel}
        if any("bias" in p for p in parts):
            out["bias"] = torch.cat([
                p.get("bias", torch.zeros(p["kernel"].shape[1],
                                          dtype=kernel.dtype,
                                          device=kernel.device))
                for p in parts])
        return out

    out = dict(params)
    layers = []
    for layer in params["layers"]:
        layer = {**layer, "attn": dict(layer["attn"]),
                 "mlp": dict(layer["mlp"])}
        a = layer["attn"]
        layer["attn"] = {"qkv": fuse([a["q"], a["k"], a["v"]]), "o": a["o"]}
        m = layer["mlp"]
        if "gate" in m:
            layer["mlp"] = {"gate_up": fuse([m["gate"], m["up"]]),
                            "down": m["down"]}
        layers.append(layer)
    out["layers"] = layers
    return out


@functools.lru_cache(maxsize=None)
def _alibi_tensor(n_heads: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(alibi_slopes(n_heads)).to(device)


def _slopes(cfg, device):
    """The ALiBi slopes (H,) f32 on ``device``, or None: one tensor per
    (heads, device), copied from the host once, so that a decode step
    copies nothing from the host and a CUDA graph can capture it."""
    if cfg.positional != "alibi":
        return None
    return _alibi_tensor(cfg.n_heads, torch.device(device))


def _hidden(cfg, params, tokens, use_kernel, stats):
    """The last block's output of a full-sequence forward (``stats``:
    updated in the dict)."""
    b, t = tokens.shape
    positions = torch.arange(t, device=tokens.device).expand(b, t)
    slopes = _slopes(cfg, tokens.device)
    x = _embed(cfg, params, tokens, positions, use_kernel)
    for i, layer in enumerate(params["layers"]):
        x = _block(cfg, layer, x, positions, None, slopes, use_kernel,
                   stats, i)
    return x


def forward(cfg: TransformerConfig, params, tokens: torch.Tensor,
            use_kernel: Optional[bool] = None,
            stats: Optional[Dict[str, LayerStats]] = None):
    """Full-sequence causal forward: tokens (B, T) -> logits (B, T, V).
    With ``stats``, returns (logits, the updated statistics)."""
    if use_kernel is None:
        use_kernel = tokens.is_cuda
    if stats is not None:
        stats = dict(stats)
    x = _hidden(cfg, params, tokens, use_kernel, stats)
    logits = unembed_logits(cfg, params, x, use_kernel)
    return logits if stats is None else (logits, stats)


def init_calibration_stats(cfg: TransformerConfig,
                           device="cuda") -> Dict[str, LayerStats]:
    """Fresh statistics for every quantizable linear."""
    dims = {"fc2": cfg.d_ff, "down": cfg.d_ff}
    return {name: init_stats(dims.get(name.split(".")[-1], cfg.d_model),
                             device)
            for name in layer_names(cfg)}


def calibrate_step(cfg: TransformerConfig, params, tokens: torch.Tensor,
                   stats: Dict[str, LayerStats]) -> Dict[str, LayerStats]:
    """One calibration batch: the forward's blocks (the kernels where the
    tokens are on CUDA), every linear's statistics updated; the logits,
    which nothing reads, are not computed."""
    stats = dict(stats)
    _hidden(cfg, params, tokens, tokens.is_cuda, stats)
    return stats


# ---- KV-cache serving -------------------------------------------------------


def _kv_planes(shape, dtype, scale_dtype, device):
    """Zeroed K and V planes of ``shape`` (..., D); int8 ones get per-row
    scale planes shape[:-1], bf16 by default (the serving default)."""
    dev = resolve_device(device)
    out = {"k": torch.zeros(shape, dtype=dtype, device=dev),
           "v": torch.zeros(shape, dtype=dtype, device=dev)}
    if dtype == torch.int8:
        scale_dtype = scale_dtype or torch.bfloat16
        out["k_scale"] = torch.zeros(shape[:-1], dtype=scale_dtype,
                                     device=dev)
        out["v_scale"] = torch.zeros(shape[:-1], dtype=scale_dtype,
                                     device=dev)
    return out


def init_kv_cache(cfg: TransformerConfig, batch: int, max_len: int,
                  dtype=torch.float32, scale_dtype=None, device="cuda"):
    """Stacked KV cache {'k', 'v': (L, B, KV, S, D)}; ``dtype=torch.int8``
    adds per-(token, head) scale planes {'k_scale', 'v_scale':
    (L, B, KV, S)}, bf16 by default (the serving default)."""
    return _kv_planes((cfg.n_layers, batch, cfg.kv_heads, max_len,
                       cfg.head_dim), dtype, scale_dtype, device)


def init_paged_kv_cache(cfg: TransformerConfig, total_pages: int,
                        page_size: int, slots: int, max_pages_per_seq: int,
                        dtype=torch.float32, scale_dtype=None,
                        device="cuda"):
    """Paged KV cache: a shared page pool {'k', 'v': (L, P, KV, PS, D)} and
    a page table {'page_table': (slots, max_pages_per_seq) int32}
    (ops/paged_attention.py); ``dtype=torch.int8`` adds per-token scale
    planes (L, P, KV, PS), bf16 by default. Unallocated table entries hold
    page 0 (a valid address; the kernels never read them)."""
    out = _kv_planes((cfg.n_layers, total_pages, cfg.kv_heads, page_size,
                      cfg.head_dim), dtype, scale_dtype, device)
    out["page_table"] = torch.zeros((slots, max_pages_per_seq),
                                    dtype=torch.int32,
                                    device=out["k"].device)
    return out


def decode_positions(pos, tokens: torch.Tensor):
    """(positions (B, 1) int64, pos) of a decode step: ``pos`` an int, or a
    (B,) int32 tensor on the tokens' device, which it returns as is."""
    if isinstance(pos, torch.Tensor) and pos.ndim == 1:
        return pos[:, None].long(), pos
    pos = int(pos)
    return torch.full((tokens.shape[0], 1), pos, dtype=torch.long,
                      device=tokens.device), pos


def decode_step(cfg: TransformerConfig, params, tokens: torch.Tensor, cache,
                pos, use_kernel: Optional[bool] = None):
    """One token of cached decode. tokens (B, 1); pos an int (uniform
    batch) or a (B,) int32 tensor on the tokens' device (ragged slots; the
    kernels then read it on the device, so a captured step replays at the
    positions the tensor holds); ``cache`` a slot cache or a page pool with
    its table. The cache is updated in place. Returns (logits (B, V),
    cache)."""
    if use_kernel is None:
        use_kernel = tokens.is_cuda
    positions, pos = decode_positions(pos, tokens)
    slopes = _slopes(cfg, tokens.device)
    x = _embed(cfg, params, tokens, positions, use_kernel)
    for i, layer in enumerate(params["layers"]):
        x = _block(cfg, layer, x, positions, ("decode", cache, pos, i),
                   slopes, use_kernel)
    return unembed_logits(cfg, params, x, use_kernel)[:, 0, :], cache


def prefill(cfg: TransformerConfig, params, tokens: torch.Tensor, cache,
            use_kernel: Optional[bool] = None):
    """Process a full prompt, filling the cache from position 0 (in place).
    Returns (logits (B, T, V), cache)."""
    if use_kernel is None:
        use_kernel = tokens.is_cuda
    b, t = tokens.shape
    positions = torch.arange(t, device=tokens.device).expand(b, t)
    slopes = _slopes(cfg, tokens.device)
    x = _embed(cfg, params, tokens, positions, use_kernel)
    for i, layer in enumerate(params["layers"]):
        x = _block(cfg, layer, x, positions, ("prefill", cache, i), slopes,
                   use_kernel)
    return unembed_logits(cfg, params, x, use_kernel), cache
