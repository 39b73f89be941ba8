"""Continuous-batching serving engine (port of
``sleekit_tpu/serve/engine.py``), single replica.

A fixed pool of ``max_slots`` sequences shares one stacked KV cache that
prefill and decode update IN PLACE: in slot mode a (L, max_slots, KV,
max_seq_len, D) cache, in paged mode a page pool (L, total_pages, KV,
page_size, D) with a page table, from which each admitted request takes
the pages its prompt and budget need. Prompts prefill in power-of-two
length buckets (one batched prefill per bucket) and their KV rows are
spliced into the slot or copied page by page into the pool; each step
decodes every slot, with a scalar position when all active slots agree (one
uniform position per kernel) and a (B,) vector otherwise. Greedy steps run
``fused_steps`` tokens per host round trip.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from sleekit_tpu_torch.device import resolve_device
from sleekit_tpu_torch.models.eval import (
    decode_scan, decode_scan_sampled, sample_tokens, sample_tokens_topkp)
from sleekit_tpu_torch.models.transformer import (
    TransformerConfig, decode_step, init_kv_cache, init_paged_kv_cache,
    prefill)

# The JAX kernels' append window (rows): a page size must be a multiple of
# it there, and the port accepts the same configurations.
_APPEND_WIN = 8


@dataclasses.dataclass
class Request:
    prompt: np.ndarray                 # (T,) int32
    max_new_tokens: int
    temperature: float = 0.0
    top_k: int = 0                     # 0 = disabled (full vocab)
    top_p: float = 1.0                 # 1.0 = disabled (no nucleus cut)
    eos_id: Optional[int] = None
    request_id: int = -1


@dataclasses.dataclass
class Completion:
    request_id: int
    tokens: np.ndarray                 # prompt + generated
    new_tokens: np.ndarray             # generated only
    finish_reason: str                 # "length" | "eos"


def _bucket(n: int, lo: int = 16) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


def _splice_cache(slot_cache, pool_cache, row: int, slot: int) -> None:
    """Copy prefill row ``row`` of ``slot_cache`` (all layers, its T
    positions) into pool slot ``slot``, in place."""
    for key, pool in pool_cache.items():
        src = slot_cache[key][:, row]
        t = src.shape[2]
        pool[:, slot, :, :t] = src.to(pool.dtype)


def _splice_pages(slot_cache, pool_cache, row: int, pages: List[int],
                  page_size: int) -> None:
    """Copy prefill row ``row`` of ``slot_cache`` (all layers) page by page
    into the pool: logical page j into physical page ``pages[j]``, in
    place. A page past the prefill's T positions is zero-filled, as if T
    were padded up to a multiple of the page size."""
    for key, pool in pool_cache.items():
        if key == "page_table":
            continue
        src = slot_cache[key][:, row]              # (L, KV, T[, D])
        t = src.shape[2]
        for j, page in enumerate(pages):
            n = max(0, min(page_size, t - j * page_size))
            pool[:, page, :, :n] = src[:, :, j * page_size:j * page_size + n]
            pool[:, page, :, n:] = 0


class Engine:
    """Continuous-batching generation engine over (packed) params.

    The KV cache ``self.cache`` is updated in place by every prefill splice
    and decode step. ``use_kernel`` (default: ``device`` is CUDA) launches
    the CUDA kernels; ``use_kernel=False`` runs their plain PyTorch
    versions on the same device (the counterpart of the JAX package's
    ``use_pallas``).

    ``paged=True`` keeps the cache in a page pool of ``total_pages`` pages
    of ``page_size`` rows (default: half the slot cache's rows, at least
    one max-length sequence and the trash page). Page 0 is the trash page:
    every inactive slot's table row points at it, so its garbage decode
    appends touch no live page. Admission is FIFO and waits while the pool
    cannot hold the head request's prompt and budget.
    """

    def __init__(self, cfg: TransformerConfig, params, max_slots: int = 8,
                 max_seq_len: int = 512, cache_dtype=torch.float32,
                 seed: int = 0, fused_steps: int = 8, paged: bool = False,
                 page_size: int = 64, total_pages: Optional[int] = None,
                 mesh=None, device="cuda",
                 use_kernel: Optional[bool] = None):
        self.device = resolve_device(device)
        if mesh is not None:
            raise NotImplementedError(
                "mesh serving is not ported yet (ROADMAP queue 1, item 15: "
                "parallel/ and serve/router.py)")
        self.cfg = cfg
        self.params = params
        self.max_slots = max_slots
        self.max_seq_len = max_seq_len
        self.cache_dtype = cache_dtype
        self.paged = paged
        self.use_kernel = (self.device.type == "cuda" if use_kernel is None
                           else use_kernel)
        if paged:
            if page_size <= 0 or page_size % _APPEND_WIN:
                raise ValueError(f"page_size {page_size} must be a positive "
                                 f"multiple of {_APPEND_WIN}")
            if max_seq_len % page_size:
                raise ValueError(f"max_seq_len {max_seq_len} must be a "
                                 f"multiple of page_size {page_size}")
            self.page_size = page_size
            self.max_pages = max_seq_len // page_size
            self.total_pages = total_pages or max(
                self.max_pages + 1, max_slots * self.max_pages // 2)
            if self.total_pages < self.max_pages + 1:
                raise ValueError(
                    f"total_pages {self.total_pages} cannot hold one "
                    f"max-length sequence ({self.max_pages} pages) and the "
                    f"trash page")
            self.cache = init_paged_kv_cache(
                cfg, self.total_pages, page_size, max_slots, self.max_pages,
                cache_dtype, device=self.device)
            self._free_pages: List[int] = list(range(1, self.total_pages))
            self._slot_pages: Dict[int, List[int]] = {}
        else:
            self.cache = init_kv_cache(cfg, max_slots, max_seq_len,
                                       cache_dtype, device=self.device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        # When every active slot has >= fused_steps budget left and the
        # queue is drained, decode fused_steps tokens per host round trip.
        self.fused_steps = fused_steps

        self.slot_req: List[Optional[Request]] = [None] * max_slots
        self.slot_tokens: List[List[int]] = [[] for _ in range(max_slots)]
        self.slot_new: List[List[int]] = [[] for _ in range(max_slots)]
        self.slot_pos = np.zeros(max_slots, np.int32)      # next write pos
        self.slot_last = np.zeros(max_slots, np.int32)     # last emitted
        self.queue: List[Request] = []
        self.finished: List[Completion] = []
        self._next_id = 0

    def _t(self, x, dtype):
        return torch.as_tensor(np.asarray(x), dtype=dtype,
                               device=self.device)

    # ---- public API -----------------------------------------------------

    def submit(self, req: Request) -> int:
        if req.request_id < 0:
            req.request_id = self._next_id
            self._next_id += 1
        if len(req.prompt) + req.max_new_tokens > self.max_seq_len:
            raise ValueError("request longer than engine max_seq_len")
        self.queue.append(req)
        return req.request_id

    def run(self, requests: Sequence[Request]) -> List[Completion]:
        """Submit all requests, step until drained, return completions in
        submission order."""
        ids = [self.submit(r) for r in requests]
        while self.has_work():
            self.step_auto()
        by_id = {c.request_id: c for c in self.finished}
        out = [by_id[i] for i in ids]
        done = set(ids)
        self.finished = [c for c in self.finished
                         if c.request_id not in done]
        return out

    def step_auto(self) -> None:
        """One scheduling iteration: fused multi-token decode when
        eligible, else a single step."""
        self._admit()
        active = [i for i, r in enumerate(self.slot_req) if r is not None]
        if self.fused_steps > 1 and active and not self.queue:
            remaining = min(self.slot_req[i].max_new_tokens
                            - len(self.slot_new[i]) for i in active)
            k = min(self.fused_steps, remaining)
            if k > 1:
                self._step_fused(active, k)
                return
        self.step()

    def has_work(self) -> bool:
        return bool(self.queue) or any(r is not None for r in self.slot_req)

    # ---- internals --------------------------------------------------------

    def _pages_needed(self, req: Request) -> int:
        return -(-(len(req.prompt) + req.max_new_tokens) // self.page_size)

    def _slot_pos_arg(self, active):
        """An int when every active slot sits at one position (inactive
        slots then write garbage there, harmless: their rows are
        re-prefilled on admission), else the (B,) int32 position vector."""
        pos_np = np.minimum(self.slot_pos, self.max_seq_len - 1)
        uniq = {int(pos_np[i]) for i in active}
        if len(uniq) == 1:
            return next(iter(uniq))
        return self._t(pos_np, torch.int32)

    def _sampling_args(self):
        reqs = self.slot_req
        temps = self._t([r.temperature if r else 0.0 for r in reqs],
                        torch.float32)
        tks = self._t([r.top_k if r else 0 for r in reqs], torch.int64)
        tps = self._t([r.top_p if r else 1.0 for r in reqs], torch.float32)
        use_topkp = any(r and (r.top_k > 0 or r.top_p < 1.0) for r in reqs)
        return temps, tks, tps, use_topkp

    def _step_fused(self, active, k: int) -> None:
        last = self._t(self.slot_last, torch.int32)
        pos = self._slot_pos_arg(active)
        if any(r and r.temperature > 0 for r in self.slot_req):
            temps, tks, tps, use_topkp = self._sampling_args()
            toks, self.cache, _, _ = decode_scan_sampled(
                self.cfg, self.params, self.cache, last, pos, k, temps, tks,
                tps, self.generator, use_topkp, use_kernel=self.use_kernel)
        else:
            toks, self.cache, _, _ = decode_scan(
                self.cfg, self.params, self.cache, last, pos, k,
                use_kernel=self.use_kernel)
        toks = toks.cpu().numpy()  # (slots, k)
        for slot in active:
            req = self.slot_req[slot]
            emitted = toks[slot].tolist()
            if req.eos_id is not None and req.eos_id in emitted:
                emitted = emitted[: emitted.index(req.eos_id) + 1]
            self.slot_tokens[slot].extend(emitted)
            self.slot_new[slot].extend(emitted)
            self.slot_pos[slot] += len(emitted)
            self.slot_last[slot] = emitted[-1]
            self._maybe_finish(slot)

    def _admit(self) -> None:
        """Admit queued requests into free slots: one batched prefill per
        length bucket, rows padded to a power of two. In paged mode a
        request first takes its pages and writes its table row; the head of
        the queue waits while the pool is short (FIFO)."""
        free = [i for i in range(self.max_slots) if self.slot_req[i] is None]
        admitted = []
        for slot in free:
            if not self.queue:
                break
            if self.paged:
                needed = self._pages_needed(self.queue[0])
                if needed > len(self._free_pages):
                    break
                pages = [self._free_pages.pop() for _ in range(needed)]
                self._slot_pages[slot] = pages
                row = torch.zeros(self.max_pages, dtype=torch.int32)
                row[:needed] = torch.as_tensor(pages, dtype=torch.int32)
                self.cache["page_table"][slot] = row.to(self.device)
            admitted.append((slot, self.queue.pop(0)))
        if not admitted:
            return
        groups: Dict[int, list] = {}
        for slot, req in admitted:
            bucket = min(_bucket(len(req.prompt)), self.max_seq_len)
            groups.setdefault(bucket, []).append((slot, req))

        for bucket, items in groups.items():
            rows = _bucket(len(items), lo=1)
            padded = np.zeros((rows, bucket), np.int32)
            lengths = []
            for r, (slot, req) in enumerate(items):
                prompt = np.asarray(req.prompt, np.int32)
                padded[r, :len(prompt)] = prompt
                lengths.append(len(prompt))
            tmp_cache = init_kv_cache(self.cfg, rows, bucket,
                                      self.cache_dtype, device=self.device)
            logits, tmp_cache = prefill(
                self.cfg, self.params, self._t(padded, torch.int64),
                tmp_cache, use_kernel=self.use_kernel)
            # First generated token comes from the last REAL prompt position.
            last_logits = logits[torch.arange(len(items)),
                                 self._t(lengths, torch.int64) - 1]
            temps = self._t([req.temperature for _, req in items],
                            torch.float32)
            if any(req.top_k > 0 or req.top_p < 1.0 for _, req in items):
                tks = self._t([req.top_k for _, req in items], torch.int64)
                tps = self._t([req.top_p for _, req in items], torch.float32)
                firsts = sample_tokens_topkp(last_logits, temps, tks, tps,
                                             self.generator)
            else:
                firsts = sample_tokens(last_logits, temps, self.generator)
            firsts = firsts.cpu().numpy()
            for r, (slot, req) in enumerate(items):
                if self.paged:
                    n_pages = -(-len(req.prompt) // self.page_size)
                    _splice_pages(tmp_cache, self.cache, r,
                                  self._slot_pages[slot][:n_pages],
                                  self.page_size)
                else:
                    _splice_cache(tmp_cache, self.cache, r, slot)
                nxt = int(firsts[r])
                prompt = np.asarray(req.prompt, np.int32)
                self.slot_req[slot] = req
                self.slot_tokens[slot] = prompt.tolist() + [nxt]
                self.slot_new[slot] = [nxt]
                self.slot_pos[slot] = len(prompt)
                self.slot_last[slot] = nxt
                self._maybe_finish(slot)

    def _maybe_finish(self, slot: int) -> None:
        req = self.slot_req[slot]
        if req is None:
            return
        new = self.slot_new[slot]
        reason = None
        if req.eos_id is not None and new and new[-1] == req.eos_id:
            reason = "eos"
        elif len(new) >= req.max_new_tokens:
            reason = "length"
        if reason:
            self.finished.append(Completion(
                request_id=req.request_id,
                tokens=np.asarray(self.slot_tokens[slot], np.int32),
                new_tokens=np.asarray(new, np.int32),
                finish_reason=reason))
            self.slot_req[slot] = None
            self.slot_tokens[slot] = []
            self.slot_new[slot] = []
            if self.paged and slot in self._slot_pages:
                # Return the pages; park the slot on the trash page.
                self._free_pages.extend(self._slot_pages.pop(slot))
                self.cache["page_table"][slot] = 0

    def step(self) -> None:
        """One engine iteration: admit new requests, one decode step for
        all slots, collect finished sequences."""
        self._admit()
        active = [i for i, r in enumerate(self.slot_req) if r is not None]
        if not active:
            return
        tokens = self._t(self.slot_last[:, None], torch.int64)
        pos = self._slot_pos_arg(active)
        logits, self.cache = decode_step(self.cfg, self.params, tokens,
                                         self.cache, pos,
                                         use_kernel=self.use_kernel)
        temps, tks, tps, use_topkp = self._sampling_args()
        if use_topkp:
            nxt = sample_tokens_topkp(logits, temps, tks, tps,
                                      self.generator)
        else:
            nxt = sample_tokens(logits, temps, self.generator)
        nxt = nxt.cpu().numpy()
        for slot in active:
            tok = int(nxt[slot])
            self.slot_tokens[slot].append(tok)
            self.slot_new[slot].append(tok)
            self.slot_pos[slot] += 1
            self.slot_last[slot] = tok
            self._maybe_finish(slot)
