"""Greedy and sampled generation (port of the generation half of
``sleekit_tpu/models/eval.py``; perplexity comes with the quantizer).

JAX's ``lax.scan`` over decode steps is a Python loop here (CUDA graphs
are a later step). Sampling draws from an explicit ``torch.Generator``;
its numbers differ from ``jax.random``'s, so sampled runs are reproducible
per generator, not token-equal to the JAX package.
"""

from __future__ import annotations

from typing import Optional

import torch

from sleekit_tpu_torch.models.transformer import (
    TransformerConfig, decode_step, init_kv_cache, prefill)


def _categorical(logits: torch.Tensor, generator) -> torch.Tensor:
    """One sample per row of ``logits`` (Gumbel-max)."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


def sample_tokens(logits, temps, generator):
    """Per-slot greedy/temperature sampling (greedy where temp == 0)."""
    greedy = torch.argmax(logits, dim=-1)
    safe_t = torch.clamp(temps, min=1e-4)
    sampled = _categorical(logits.float() / safe_t[:, None], generator)
    return torch.where(temps > 0, sampled, greedy).to(torch.int32)


def sample_tokens_topkp(logits, temps, top_ks, top_ps, generator):
    """Per-slot greedy / temperature / top-k / top-p sampling. top_k == 0
    and top_p >= 1 each disable their cut exactly."""
    V = logits.shape[-1]
    greedy = torch.argmax(logits, dim=-1)
    safe_t = torch.clamp(temps, min=1e-4)
    scaled = logits.float() / safe_t[:, None]
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    k = torch.where(top_ks > 0, top_ks, V).long()
    kth = torch.gather(sorted_desc, 1, (k - 1)[:, None])
    masked = torch.where(scaled < kth, -torch.inf, scaled)
    pos = torch.arange(V, device=logits.device)[None, :]
    sorted_masked = torch.where(pos < k[:, None], sorted_desc, -torch.inf)
    sp = torch.softmax(sorted_masked, dim=-1)
    cum = torch.cumsum(sp, dim=-1)
    # Keep tokens whose exclusive cumulative mass is < p (the argmax token
    # always survives); top_p >= 1 keeps the whole k-masked distribution.
    keep = ((cum - sp) < top_ps[:, None]) | (top_ps[:, None] >= 1.0)
    thresh = torch.where(keep, sorted_masked, torch.inf).amin(dim=-1)
    final = torch.where(masked >= thresh[:, None], masked, -torch.inf)
    sampled = _categorical(final, generator)
    return torch.where(temps > 0, sampled, greedy).to(torch.int32)


def decode_scan(cfg: TransformerConfig, params, cache, last_token, pos0,
                steps: int, use_kernel: Optional[bool] = None):
    """``steps`` greedy decode steps. last_token (B,) on the device; pos0 an
    int or a (B,) int32 tensor. The cache is updated in place. Returns
    (tokens (B, steps), cache, last (B,), pos)."""
    last, pos, toks = last_token, pos0, []
    for _ in range(steps):
        logits, cache = decode_step(cfg, params, last[:, None], cache, pos,
                                    use_kernel=use_kernel)
        last = torch.argmax(logits, dim=-1).to(torch.int32)
        toks.append(last)
        pos = pos + 1
    return torch.stack(toks, dim=1), cache, last, pos


def decode_scan_sampled(cfg: TransformerConfig, params, cache, last_token,
                        pos0, steps: int, temps, top_ks, top_ps, generator,
                        use_topkp: bool = False,
                        use_kernel: Optional[bool] = None):
    """Multi-token decode with per-slot sampling on the device (greedy
    slots take argmax). Returns (tokens (B, steps), cache, last, pos)."""
    last, pos, toks = last_token, pos0, []
    for _ in range(steps):
        logits, cache = decode_step(cfg, params, last[:, None], cache, pos,
                                    use_kernel=use_kernel)
        if use_topkp:
            last = sample_tokens_topkp(logits, temps, top_ks, top_ps,
                                       generator)
        else:
            last = sample_tokens(logits, temps, generator)
        toks.append(last)
        pos = pos + 1
    return torch.stack(toks, dim=1), cache, last, pos


def generate_fused(cfg: TransformerConfig, params, prompt: torch.Tensor,
                   max_new_tokens: int, max_len: Optional[int] = None,
                   use_kernel: Optional[bool] = None) -> torch.Tensor:
    """Greedy generation: prefill, then :func:`decode_scan`."""
    b, t = prompt.shape
    max_len = max_len or (t + max_new_tokens)
    cache = init_kv_cache(cfg, b, max_len, device=prompt.device)
    logits, cache = prefill(cfg, params, prompt, cache, use_kernel)
    first = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
    if max_new_tokens == 1:
        return torch.cat([prompt, first[:, None].to(prompt.dtype)], dim=1)
    toks, _, _, _ = decode_scan(cfg, params, cache, first, t,
                                max_new_tokens - 1, use_kernel)
    return torch.cat([prompt, first[:, None].to(prompt.dtype),
                      toks.to(prompt.dtype)], dim=1)


def generate(cfg: TransformerConfig, params, prompt: torch.Tensor,
             max_new_tokens: int, temperature: float = 0.0,
             generator: Optional[torch.Generator] = None,
             max_len: Optional[int] = None,
             use_kernel: Optional[bool] = None) -> torch.Tensor:
    """Autoregressive generation with a KV cache: prompt (B, T) ->
    (B, T + max_new_tokens). Greedy when temperature == 0."""
    b, t = prompt.shape
    max_len = max_len or (t + max_new_tokens)
    cache = init_kv_cache(cfg, b, max_len, device=prompt.device)
    logits, cache = prefill(cfg, params, prompt, cache, use_kernel)
    last = logits[:, -1, :]
    out = [prompt]
    for i in range(max_new_tokens):
        if temperature > 0:
            nxt = _categorical(last / temperature, generator)
        else:
            nxt = torch.argmax(last, dim=-1)
        nxt = nxt.to(prompt.dtype)[:, None]
        out.append(nxt)
        last, cache = decode_step(cfg, params, nxt, cache, t + i, use_kernel)
    return torch.cat(out, dim=1)
