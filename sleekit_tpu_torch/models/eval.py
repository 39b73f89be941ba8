"""Evaluation: causal-LM perplexity and greedy/sampled generation (port of
``sleekit_tpu/models/eval.py``).

JAX compiles its decode loops into one device program (``lax.scan`` over
``decode_step``, under ``jax.jit``). Here :class:`DecodeGraph` holds one
decode step over static device buffers and, on CUDA with the kernels,
captures it once as a CUDA graph: K steps are K replays, the position and
the last token advancing on the device between them. Elsewhere (the CPU,
or ``graphs=False``) the same step body runs eagerly over the same
buffers. :func:`decode_scan`, :func:`decode_scan_sampled`,
:func:`generate_fused`, :func:`generate` and :func:`decode_perplexity`
run through it, as does the serving Engine.

Sampling draws from an explicit ``torch.Generator``; its numbers differ
from ``jax.random``'s, so sampled runs are reproducible per generator, not
token-equal to the JAX package.
"""

from __future__ import annotations

import gc
import time
from typing import Iterable, Optional

import numpy as np
import torch

from sleekit_tpu_torch import kernels
from sleekit_tpu_torch.device import resolve_device
from sleekit_tpu_torch.models.transformer import (
    TransformerConfig, decode_step, forward, init_kv_cache, prefill)
from sleekit_tpu_torch.ops import attention
from sleekit_tpu_torch.parallel.tp_decode import tp_decode_step


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


def _route_knobs():
    """The ``ops/attention`` knobs that pick a decode step's kernels; JAX
    reads them when it traces, and a captured graph freezes them too."""
    return (attention.FLASH_FUSED_APPEND, attention.FLASH_MHA_MODE,
            attention.FLASH_BATCH_FOLD)


class DecodeGraph:
    """One decode step of a batch of ``batch`` rows over static buffers,
    run ``steps`` times a call; on CUDA with ``graphs`` (default: the
    device is CUDA and ``use_kernel``), captured once as a CUDA graph and
    replayed.

    Buffers (the caller fills them with ``copy_`` before :meth:`run`):
    ``last`` (B,) int32, the token each row decodes next; ``pos`` (B,)
    int32, its cache row; ``temps`` (B,) f32, ``top_ks`` (B,) int64 and
    ``top_ps`` (B,) f32, the sampling knobs; ``tokens`` (B, max_steps)
    int32. A step decodes ``last`` at ``pos``, picks the next token by
    ``mode`` - 'greedy' (argmax), 'sample' (:func:`sample_tokens`),
    'topkp' (:func:`sample_tokens_topkp`), or 'nll' (teacher forcing: the
    next token is ``tokens[:, i]``, and the step writes its negative
    log-likelihood to ``nll[:, i]``) - and, at step i of the call, writes
    it to ``tokens[:, i]`` (except 'nll') and ``last``, then advances
    ``pos``.

    The graph's first capture, and a capture again, runs the call's first
    step eagerly on a side stream (so every buffer that a kernel's wrapper
    allocates once exists before the capture) and then captures the next;
    the call's other steps are replays. A graph is keyed on the cache
    tensors' addresses and the route knobs (:func:`_route_knobs`): a call
    with another key captures again. The kernels' calls in the capture
    count as launches at each replay (``kernels.add_launches``). The
    sampling modes draw from ``generator`` (the device's default when
    None), which is registered with the graph, so replays draw from it as
    the eager steps do.

    With a ``mesh`` (``parallel/mesh.py``), the step is this rank's
    ``tp_decode_step`` over its shard of ``params`` and of the cache. Its
    NCCL collectives are captured with the kernels, and its group counts
    them at each replay; gloo's cannot be captured, so over gloo the step
    runs eagerly (``graphs=True`` raises).
    """

    MODES = ("greedy", "sample", "topkp", "nll")

    def __init__(self, cfg: TransformerConfig, params, batch: int,
                 max_steps: int, mode: str = "greedy", generator=None,
                 device="cuda", use_kernel: Optional[bool] = None,
                 graphs: Optional[bool] = None, mesh=None):
        if mode not in self.MODES:
            raise ValueError(f"mode {mode!r} not in {self.MODES}")
        dev = resolve_device(device)
        self.use_kernel = (dev.type == "cuda" if use_kernel is None
                           else use_kernel)
        self.group = None if mesh is None else mesh.group
        capturable = self.group is None or self.group.capturable
        self.graphs = (dev.type == "cuda" and self.use_kernel and capturable
                       if graphs is None else graphs)
        if self.graphs and dev.type != "cuda":
            raise ValueError("graphs=True needs a CUDA device")
        if self.graphs and not capturable:
            raise ValueError(f"graphs=True: {self.group.backend} collectives "
                             "cannot be captured in a CUDA graph")
        self.cfg, self.params, self.mode, self.mesh = cfg, params, mode, mesh
        self.generator = generator
        self.max_steps = max_steps
        self.last = torch.zeros(batch, dtype=torch.int32, device=dev)
        self.pos = torch.zeros(batch, dtype=torch.int32, device=dev)
        self.temps = torch.zeros(batch, dtype=torch.float32, device=dev)
        self.top_ks = torch.zeros(batch, dtype=torch.int64, device=dev)
        self.top_ps = torch.ones(batch, dtype=torch.float32, device=dev)
        self.tokens = torch.zeros((batch, max_steps), dtype=torch.int32,
                                  device=dev)
        self.nll = (torch.zeros((batch, max_steps), dtype=torch.float32,
                                device=dev) if mode == "nll" else None)
        self._index = torch.zeros(1, dtype=torch.int64, device=dev)
        self.graph = None
        self._key = None
        self._stream = None
        # The kernels' calls and the collectives in one captured step; the
        # captures (each after one eager step), the host's seconds in them,
        # and the replays.
        self.captured = {}
        self.captured_collectives = {}
        self.captures = self.replays = 0
        self.capture_s = 0.0

    def _step(self, cache) -> None:
        if self.mesh is None:
            logits, _ = decode_step(self.cfg, self.params, self.last[:, None],
                                    cache, self.pos,
                                    use_kernel=self.use_kernel)
        else:
            logits, _ = tp_decode_step(self.cfg, self.params,
                                       self.last[:, None], cache, self.pos,
                                       self.mesh, use_kernel=self.use_kernel)
        if self.mode == "nll":
            nxt = self.tokens.index_select(1, self._index)[:, 0]
            logp = torch.log_softmax(logits.float(), dim=-1)
            nll = -torch.gather(logp, 1, nxt[:, None].long())
            self.nll.index_copy_(1, self._index, nll)
        else:
            if self.mode == "greedy":
                nxt = torch.argmax(logits, dim=-1).to(torch.int32)
            elif self.mode == "sample":
                nxt = sample_tokens(logits, self.temps, self.generator)
            else:
                nxt = sample_tokens_topkp(logits, self.temps, self.top_ks,
                                          self.top_ps, self.generator)
            self.tokens.index_copy_(1, self._index, nxt[:, None])
        self.last.copy_(nxt)
        self.pos.add_(1)
        self._index.add_(1)

    def _capture(self, cache, key) -> None:
        """The call's first step eagerly on the side stream, then the
        capture of one step (which runs nothing). ``torch.cuda.graph``
        would first synchronize, collect Python's garbage and empty the
        allocator's cache: host time at every capture that none of this
        needs. Python's collector is off during the capture: a collection
        there could destroy an unreachable runner's graph, and destroying
        a graph while a stream captures invalidates the capture."""
        t0 = time.perf_counter()
        self.graph = None
        if self._stream is None:
            self._stream = torch.cuda.Stream(device=self.last.device)
        self._stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(self._stream):
            self._step(cache)
        torch.cuda.current_stream().wait_stream(self._stream)
        graph = torch.cuda.CUDAGraph()
        if self.mode in ("sample", "topkp") and self.generator is not None:
            graph.register_generator_state(self.generator)
        collecting = gc.isenabled()
        gc.disable()
        issued = {} if self.group is None else dict(self.group.counts)
        try:
            with kernels.captured_launches() as calls, \
                    torch.cuda.stream(self._stream):
                # A group's threads (NCCL's watchdog) keep calling CUDA
                # during the capture: only this thread's calls are held
                # to the capture's rules.
                graph.capture_begin(capture_error_mode=(
                    "global" if self.group is None else "thread_local"))
                try:
                    self._step(cache)
                finally:
                    graph.capture_end()
        finally:
            if collecting:
                gc.enable()
            # The capture issued no collective: its replays do.
            if self.group is not None:
                self.captured_collectives = {
                    k: self.group.counts[k] - n for k, n in issued.items()}
                self.group.counts.update(issued)
        self.graph, self._key, self.captured = graph, key, calls
        self.captures += 1
        self.capture_s += time.perf_counter() - t0

    def run(self, cache, steps: int) -> None:
        """``steps`` decode steps over ``cache`` (updated in place) from
        the buffers' state; the results are in the buffers."""
        if not 1 <= steps <= self.max_steps:
            raise ValueError(f"steps {steps} not in [1, {self.max_steps}]")
        self._index.zero_()
        if not self.graphs:
            for _ in range(steps):
                self._step(cache)
            return
        key = (tuple(t.data_ptr() for t in cache.values()), _route_knobs())
        eager = 0
        if self.graph is None or key != self._key:
            self._capture(cache, key)
            eager = 1
        for _ in range(steps - eager):
            self.graph.replay()
        kernels.add_launches(self.captured, steps - eager)
        for k, n in self.captured_collectives.items():
            self.group.counts[k] += n * (steps - eager)
        self.replays += steps - eager


def _scan(cfg, params, cache, last_token, pos0, steps, mode,
          generator=None, temps=None, top_ks=None, top_ps=None,
          use_kernel=None):
    """``steps`` steps through a :class:`DecodeGraph` of this call.
    Returns (tokens (B, steps), cache, last (B,), pos)."""
    b = last_token.shape[0]
    run = DecodeGraph(cfg, params, b, steps, mode, generator,
                      last_token.device, use_kernel)
    run.last.copy_(last_token)
    run.pos.copy_(torch.as_tensor(pos0).to(run.pos.device).expand(b))
    for buf, val in ((run.temps, temps), (run.top_ks, top_ks),
                     (run.top_ps, top_ps)):
        if val is not None:
            buf.copy_(val)
    run.run(cache, steps)
    pos = (pos0 + steps if isinstance(pos0, torch.Tensor)
           else int(pos0) + steps)
    return run.tokens, cache, run.last, pos


def decode_scan(cfg: TransformerConfig, params, cache, last_token, pos0,
                steps: int, use_kernel: Optional[bool] = None):
    """``steps`` greedy decode steps. last_token (B,) on the device; pos0 an
    int or a (B,) int32 tensor. The cache is updated in place. Returns
    (tokens (B, steps), cache, last (B,), pos)."""
    return _scan(cfg, params, cache, last_token, pos0, steps, "greedy",
                 use_kernel=use_kernel)


def decode_scan_sampled(cfg: TransformerConfig, params, cache, last_token,
                        pos0, steps: int, temps, top_ks, top_ps, generator,
                        use_topkp: bool = False,
                        use_kernel: Optional[bool] = None):
    """Multi-token decode with per-slot sampling on the device (greedy
    slots take argmax). Returns (tokens (B, steps), cache, last, pos)."""
    return _scan(cfg, params, cache, last_token, pos0, steps,
                 "topkp" if use_topkp else "sample", generator, temps,
                 top_ks, top_ps, use_kernel)


def generate(cfg: TransformerConfig, params, prompt: torch.Tensor,
             max_new_tokens: int, temperature: float = 0.0,
             generator: Optional[torch.Generator] = None,
             max_len: Optional[int] = None,
             use_kernel: Optional[bool] = None) -> torch.Tensor:
    """Autoregressive generation with a KV cache: prompt (B, T) ->
    (B, T + max_new_tokens). Greedy when temperature == 0, else sampled
    from ``generator``: prefill, then the decode loop."""
    b, t = prompt.shape
    max_len = max_len or (t + max_new_tokens)
    cache = init_kv_cache(cfg, b, max_len, device=prompt.device)
    logits, cache = prefill(cfg, params, prompt, cache, use_kernel)
    temps = torch.full((b,), float(temperature), device=prompt.device)
    if temperature > 0:
        mode = "sample"
        first = sample_tokens(logits[:, -1, :], temps, generator)
    else:
        mode = "greedy"
        first = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
    out = [prompt, first[:, None].to(prompt.dtype)]
    if max_new_tokens > 1:
        toks, _, _, _ = _scan(cfg, params, cache, first, t,
                              max_new_tokens - 1, mode, generator, temps,
                              use_kernel=use_kernel)
        out.append(toks.to(prompt.dtype))
    return torch.cat(out, dim=1)


def generate_fused(cfg: TransformerConfig, params, prompt: torch.Tensor,
                   max_new_tokens: int, max_len: Optional[int] = None,
                   use_kernel: Optional[bool] = None) -> torch.Tensor:
    """Greedy generation: prefill, then :func:`decode_scan`."""
    return generate(cfg, params, prompt, max_new_tokens, max_len=max_len,
                    use_kernel=use_kernel)


# ---- perplexity -------------------------------------------------------------


def _batches(batches, device):
    for tokens in batches:
        yield torch.as_tensor(np.asarray(tokens), dtype=torch.int64,
                              device=device)


def perplexity(cfg: TransformerConfig, params, batches: Iterable,
               device="cuda", use_kernel: Optional[bool] = None) -> float:
    """Corpus perplexity over (B, T) token batches (stride = window),
    through the full-sequence :func:`forward`; the first position of a
    window has no target."""
    total, count = 0.0, 0
    for tokens in _batches(batches, resolve_device(device)):
        logits = forward(cfg, params, tokens, use_kernel)
        logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
        nll = -torch.gather(logp, 2, tokens[:, 1:, None])[..., 0]
        total += float(nll.sum())
        count += nll.numel()
    return float(np.exp(total / max(count, 1)))


def decode_perplexity(cfg: TransformerConfig, params, batches: Iterable,
                      cache_dtype=torch.float32, scale_dtype=torch.float32,
                      device="cuda", use_kernel: Optional[bool] = None,
                      graphs: Optional[bool] = None) -> float:
    """Corpus perplexity scored token by token through the decode path
    (the KV cache and ``decode_step``, the kernels the serving Engine
    runs), teacher-forced: a :class:`DecodeGraph` in 'nll' mode over each
    window, the next token fed from the window on the device. Must agree
    with :func:`perplexity` on the same params."""
    dev = resolve_device(device)
    total, count, runs = 0.0, 0, {}
    for tokens in _batches(batches, dev):
        b, t = tokens.shape
        if t < 2:
            continue
        if (b, t) not in runs:
            # Windows of one shape share a cache and a graph: a window
            # writes every row it reads before reading it.
            runs[b, t] = (
                init_kv_cache(cfg, b, t, cache_dtype, scale_dtype,
                              device=dev),
                DecodeGraph(cfg, params, b, t - 1, "nll", device=dev,
                            use_kernel=use_kernel, graphs=graphs))
        cache, run = runs[b, t]
        run.last.copy_(tokens[:, 0])
        run.pos.zero_()
        run.tokens.copy_(tokens[:, 1:])
        run.run(cache, t - 1)
        total += float(run.nll.sum())
        count += run.nll.numel()
    return float(np.exp(total / max(count, 1)))


def chunk_tokens(token_stream: np.ndarray, seq_len: int,
                 batch_size: int = 1) -> Iterable[np.ndarray]:
    """Split a flat token array into (batch, seq_len) eval windows."""
    n = (len(token_stream) // seq_len) * seq_len
    windows = token_stream[:n].reshape(-1, seq_len)
    for i in range(0, len(windows), batch_size):
        yield windows[i:i + batch_size].astype(np.int32)
