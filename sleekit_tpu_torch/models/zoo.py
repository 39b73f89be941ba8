"""Model-family configs (port of ``sleekit_tpu/models/zoo.py``): the
reference's evaluation targets and the serving targets.

Geometry sources are the public HF configs for each model; the reference
quantizes OPT-125M/350M and BLOOM-560M (SURVEY.md §6) and the north star
adds OPT-1.3B/2.7B and Llama-class serving (BASELINE.json configs 4-5).
"""

from __future__ import annotations

from sleekit_tpu_torch.models.transformer import TransformerConfig


def opt_125m(**kw) -> TransformerConfig:
    return TransformerConfig(
        vocab_size=50272, d_model=768, n_layers=12, n_heads=12, d_ff=3072,
        max_seq_len=2048, activation="relu", norm="layernorm",
        positional="learned", pre_norm=True, learned_pos_offset=2,
        final_ln=True, tie_embeddings=True, **kw)


def opt_350m(**kw) -> TransformerConfig:
    # OPT-350M is post-norm and projects 512-dim embeddings to 1024.
    return TransformerConfig(
        vocab_size=50272, d_model=1024, n_layers=24, n_heads=16, d_ff=4096,
        max_seq_len=2048, activation="relu", norm="layernorm",
        positional="learned", pre_norm=False, learned_pos_offset=2,
        final_ln=False, tie_embeddings=True, embed_dim=512, **kw)


def opt_1b3(**kw) -> TransformerConfig:
    return TransformerConfig(
        vocab_size=50272, d_model=2048, n_layers=24, n_heads=32, d_ff=8192,
        max_seq_len=2048, activation="relu", norm="layernorm",
        positional="learned", pre_norm=True, learned_pos_offset=2,
        final_ln=True, tie_embeddings=True, **kw)


def opt_2b7(**kw) -> TransformerConfig:
    return TransformerConfig(
        vocab_size=50272, d_model=2560, n_layers=32, n_heads=32, d_ff=10240,
        max_seq_len=2048, activation="relu", norm="layernorm",
        positional="learned", pre_norm=True, learned_pos_offset=2,
        final_ln=True, tie_embeddings=True, **kw)


def bloom_560m(**kw) -> TransformerConfig:
    return TransformerConfig(
        vocab_size=250880, d_model=1024, n_layers=24, n_heads=16, d_ff=4096,
        max_seq_len=2048, activation="gelu", norm="layernorm",
        positional="alibi", pre_norm=True, embed_ln=True,
        final_ln=True, tie_embeddings=True, **kw)


def llama2_7b(**kw) -> TransformerConfig:
    return TransformerConfig(
        vocab_size=32000, d_model=4096, n_layers=32, n_heads=32,
        n_kv_heads=32, d_ff=11008, max_seq_len=4096,
        activation="silu_glu", norm="rmsnorm", positional="rope",
        pre_norm=True, final_ln=True, tie_embeddings=False,
        norm_eps=1e-6, **kw)


def llama3_8b(**kw) -> TransformerConfig:
    return TransformerConfig(
        vocab_size=128256, d_model=4096, n_layers=32, n_heads=32,
        n_kv_heads=8, d_ff=14336, max_seq_len=8192,
        activation="silu_glu", norm="rmsnorm", positional="rope",
        rope_theta=500000.0, pre_norm=True, final_ln=True,
        tie_embeddings=False, norm_eps=1e-6, **kw)


def qwen2_7b(**kw) -> TransformerConfig:
    """Qwen/Qwen2-7B: llama-family architecture + q/k/v biases and a
    ragged FFN width (18944 - exercises the blocked triangular inverse's
    ragged path, hessian._tri_inv_lower)."""
    return TransformerConfig(
        vocab_size=152064, d_model=3584, n_layers=28, n_heads=28,
        n_kv_heads=4, d_ff=18944, max_seq_len=32768,
        activation="silu_glu", norm="rmsnorm", positional="rope",
        rope_theta=1e6, pre_norm=True, final_ln=True,
        tie_embeddings=False, norm_eps=1e-6, qkv_bias=True, **kw)


def tiny_test(**kw) -> TransformerConfig:
    """Small config for unit tests and smoke runs."""
    defaults = dict(
        vocab_size=256, d_model=64, n_layers=2, n_heads=4, d_ff=128,
        max_seq_len=128, activation="relu", norm="layernorm",
        positional="learned", pre_norm=True, final_ln=True,
        tie_embeddings=True)
    defaults.update(kw)
    return TransformerConfig(**defaults)


ZOO = {
    "opt-125m": opt_125m,
    "opt-350m": opt_350m,
    "opt-1.3b": opt_1b3,
    "opt-2.7b": opt_2b7,
    "bloom-560m": bloom_560m,
    "llama2-7b": llama2_7b,
    "llama3-8b": llama3_8b,
    "qwen2-7b": qwen2_7b,
    "tiny": tiny_test,
}


def get_config(name: str, **kw) -> TransformerConfig:
    return ZOO[name](**kw)
