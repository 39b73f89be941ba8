"""Tensor-parallel prefill and decode (port of
``sleekit_tpu/parallel/tp_decode.py``): Megatron-style column-then-row
parallelism, one process a rank.

The JAX package runs its single-device decode code inside ``shard_map``,
each device on its shard of heads and ff, with two ``psum``s a layer and
one ``all_gather`` of the logits. Here every rank runs the port's
single-device code (the same kernels, at local shapes) on its own block
of the params and the cache (``mesh.shard_params``,
``mesh.shard_kv_cache``), and its :class:`~sleekit_tpu_torch.parallel.
distributed.TPGroup` issues the collectives:

* q/k/v, fc1 (gate/up): column-parallel, K1 with the norm in its
  prologue, on the rank's heads and ff;
* o, fc2 (down): row-parallel, K1 without bias or residual over the
  rank's ``split_packed_k`` rows; the partial outputs are all-reduced in
  the activations' dtype, then the replicated bias and the residual are
  added, as the JAX package sums its bf16 outputs before both;
* the KV cache (slot or paged) holds the rank's kv heads; K3/K5 at decode,
  K10's prompt write and K4 at prefill, at the local head count;
* the lm_head (K2) is vocab-sharded and its logits are all-gathered
  before the padded vocabulary is cut.

Params must be unfused (``mesh.prepare_params_for_tp``). Every rank takes
the same tokens and positions and returns the same logits.

JAX's ``_tp_block`` and ``_tp_prefill_block`` are one :func:`_tp_block`
here, its ``kv`` picking decode or prefill as ``transformer._block``'s
does; JAX's ``_prefill_bias`` is ``transformer._causal_bias`` over the
rank's slopes (or K4's mask), and its ``_localize_packed`` is part of
``mesh.shard_params``, since no ``shard_map`` re-attaches global static
fields.
"""

from __future__ import annotations

import dataclasses

import torch

from sleekit_tpu_torch.models.transformer import (
    TransformerConfig, _attend, _embed, _fused_proj, _slopes, _unembed,
    apply_norm, decode_positions, finalize_logits)
from sleekit_tpu_torch.parallel.mesh import Mesh
from sleekit_tpu_torch.ops.pack import PackedLinear


def _local_cfg(cfg: TransformerConfig, n: int) -> TransformerConfig:
    """The attention's local config on one of ``n`` ranks: its heads and kv
    heads, and the width they span (d_model / n), so that ``head_dim``
    stays the model's."""
    if cfg.n_heads % n or cfg.kv_heads % n:
        raise ValueError(f"{cfg.n_heads} heads / {cfg.kv_heads} kv heads "
                         f"not divisible by model-parallel size {n}")
    return dataclasses.replace(cfg, d_model=cfg.d_model // n,
                               n_heads=cfg.n_heads // n,
                               n_kv_heads=cfg.kv_heads // n)


def _strip_row_bias(p):
    """A row-parallel linear without its bias, and the bias (added once,
    after the all-reduce)."""
    if isinstance(p, PackedLinear):
        return dataclasses.replace(p, bias=None), p.bias
    if "bias" in p:
        return {"kernel": p["kernel"]}, p["bias"]
    return p, None


def _row_parallel(cfg, p, h, x, mesh: Mesh, use_kernel: bool, act=None):
    """``x + (sum over ranks of act(h) @ W_rank) + bias``: the rank's
    partial product (K1 with ``act`` in its prologue, no bias, no
    residual), all-reduced, then the bias and the residual added in f32
    and rounded once to the residual stream's dtype."""
    p, bias = _strip_row_bias(p)
    y = _fused_proj(cfg, p, h, act=act, use_kernel=use_kernel)
    if mesh.group is not None:
        y = mesh.group.all_reduce(y)
    if bias is not None:
        y = y + bias
    return (x + y).to(x.dtype)


def _tp_block(cfg, lcfg, layer, x, positions, kv, slopes, mesh: Mesh,
              use_kernel: bool):
    """One block on the rank's heads and ff; ``kv`` as
    ``transformer._block`` takes it, over the rank's cache. Two
    all-reduces."""
    ln1 = layer["ln1"] if cfg.pre_norm else None
    q, k, v = (_fused_proj(cfg, layer["attn"][name], x, ln=ln1,
                           use_kernel=use_kernel) for name in "qkv")
    attn = _attend(lcfg, q, k, v, positions, kv, slopes, use_kernel)
    x = _row_parallel(cfg, layer["attn"]["o"], attn, x, mesh, use_kernel)
    if not cfg.pre_norm:
        x = apply_norm(cfg, layer["ln1"], x)
    ln2 = layer["ln2"] if cfg.pre_norm else None
    mlp = layer["mlp"]
    if cfg.activation == "silu_glu":
        h = torch.cat([_fused_proj(cfg, mlp[name], x, ln=ln2,
                                   use_kernel=use_kernel)
                       for name in ("gate", "up")], dim=-1)
        x = _row_parallel(cfg, mlp["down"], h, x, mesh, use_kernel,
                          act="silu_glu")
    else:
        h = _fused_proj(cfg, mlp["fc1"], x, ln=ln2, use_kernel=use_kernel)
        x = _row_parallel(cfg, mlp["fc2"], h, x, mesh, use_kernel,
                          act=cfg.activation)
    if not cfg.pre_norm:
        x = apply_norm(cfg, layer["ln2"], x)
    return x


def _local_slopes(cfg, lcfg, mesh: Mesh, device):
    """The ALiBi slopes of the rank's heads (a view of the model's), or
    None."""
    slopes = _slopes(cfg, device)
    if slopes is None:
        return None
    return slopes.narrow(0, mesh.rank * lcfg.n_heads, lcfg.n_heads)


def _tp_logits(cfg, params, x, mesh: Mesh, use_kernel: bool):
    """The unembed: a vocab-sharded lm_head's logits all-gathered (then cut
    to the vocabulary); a tied head is replicated."""
    logits = _unembed(cfg, params, x, use_kernel)
    if "lm_head" in params and mesh.model > 1:
        logits = mesh.group.all_gather(logits, dim=-1)
    return finalize_logits(cfg, logits)


def _run(cfg, params, tokens, positions, kv, mesh, use_kernel):
    lcfg = _local_cfg(cfg, mesh.model)
    slopes = _local_slopes(cfg, lcfg, mesh, tokens.device)
    x = _embed(cfg, params, tokens, positions, use_kernel)
    for i, layer in enumerate(params["layers"]):
        x = _tp_block(cfg, lcfg, layer, x, positions, kv(i), slopes, mesh,
                      use_kernel)
    return _tp_logits(cfg, params, x, mesh, use_kernel)


def tp_prefill(cfg: TransformerConfig, params, tokens: torch.Tensor, cache,
               mesh: Mesh, use_kernel=None):
    """``transformer.prefill`` on this rank's shard: ``params`` and
    ``cache`` are the rank's (``shard_params``, ``shard_kv_cache`` or a
    cache of the local config), the cache filled in place from position 0.
    Returns (logits (B, T, V), cache), equal on every rank."""
    if use_kernel is None:
        use_kernel = tokens.is_cuda
    b, t = tokens.shape
    positions = torch.arange(t, device=tokens.device).expand(b, t)
    logits = _run(cfg, params, tokens, positions,
                  lambda i: ("prefill", cache, i), mesh, use_kernel)
    return logits, cache


def tp_decode_step(cfg: TransformerConfig, params, tokens: torch.Tensor,
                   cache, pos, mesh: Mesh, use_kernel=None):
    """``transformer.decode_step`` on this rank's shard (slot cache or page
    pool, updated in place): tokens (B, 1); pos an int or a (B,) int32
    tensor. Returns (logits (B, V), cache), equal on every rank."""
    if use_kernel is None:
        use_kernel = tokens.is_cuda
    positions, pos = decode_positions(pos, tokens)
    logits = _run(cfg, params, tokens, positions,
                  lambda i: ("decode", cache, pos, i), mesh, use_kernel)
    return logits[:, 0, :], cache
