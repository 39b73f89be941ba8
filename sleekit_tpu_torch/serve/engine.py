"""Continuous-batching serving engine (port of
``sleekit_tpu/serve/engine.py``): one replica, on one device or over the
model axis of a mesh; replicas behind a router are ``serve.router``'s.

A fixed pool of ``max_slots`` sequences shares one stacked KV cache that
prefill and decode update IN PLACE: in slot mode a (L, max_slots, KV,
max_seq_len, D) cache, in paged mode a page pool (L, total_pages, KV,
page_size, D) with a page table, from which each admitted request takes
the pages its prompt and budget need. Prompts prefill in power-of-two
length buckets (one batched prefill per bucket) and their KV rows are
spliced into the slot or copied page by page into the pool; each step
decodes every slot at its (B,) position vector through a
:class:`~sleekit_tpu_torch.models.eval.DecodeGraph` of its sampling mode,
which on CUDA replays one captured CUDA graph a step (the counterpart of
the JAX Engine's jitted ``decode_step`` and ``decode_scan``). Steps run
``fused_steps`` tokens per host round trip.

With a ``mesh`` of ``model > 1`` ranks (``parallel/mesh.py``), every rank
runs this Engine in lockstep on the same requests: its params and its
cache are its shard (heads and ff; ``parallel/tp_decode.py``), prefill
and decode are the tensor-parallel ones, and since the logits are equal
on every rank after their all-gather, and every rank draws from a
generator of the same seed, every rank takes the same host decisions and
emits the same tokens.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from sleekit_tpu_torch.device import resolve_device
from sleekit_tpu_torch.models.eval import (
    DecodeGraph, sample_tokens, sample_tokens_topkp)
from sleekit_tpu_torch.models.transformer import (
    TransformerConfig, init_kv_cache, init_paged_kv_cache, prefill)
from sleekit_tpu_torch.parallel.mesh import shard_params
from sleekit_tpu_torch.parallel.tp_decode import _local_cfg, tp_prefill

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
    ``use_pallas``). ``graphs`` (default: ``device`` is CUDA and
    ``use_kernel``) replays each decode step as a CUDA graph, captured at
    the first step of each sampling mode (greedy, temperature, top-k/p)
    with the ``ops/attention`` route knobs as they are then, and again
    when they change; ``graphs=False`` runs the same steps eagerly, as
    ``jax.disable_jit`` would. Prefill stays eager.

    ``paged=True`` keeps the cache in a page pool of ``total_pages`` pages
    of ``page_size`` rows (default: half the slot cache's rows, at least
    one max-length sequence and the trash page). Page 0 is the trash page:
    every inactive slot's table row points at it, so its garbage decode
    appends touch no live page. Admission is FIFO and waits while the pool
    cannot hold the head request's prompt and budget.

    ``mesh`` (``parallel.mesh.make_mesh``; ``model > 1``) serves this
    rank's shard of ``params``, which must be in the tensor-parallel
    format (``mesh.prepare_params_for_tp``), on the mesh's device. Over
    gloo the decode steps run eagerly: its collectives cannot be captured.
    At ``model == 1`` the Engine is the single-device one. A mesh with a
    data axis (``data > 1``) is refused: each replica is an Engine of its
    own behind a ``serve.router.ReplicaRouter`` (a port mesh always spans
    processes, where the JAX Engine refuses ``data > 1`` too).
    """

    def __init__(self, cfg: TransformerConfig, params, max_slots: int = 8,
                 max_seq_len: int = 512, cache_dtype=torch.float32,
                 seed: int = 0, fused_steps: int = 8, paged: bool = False,
                 page_size: int = 64, total_pages: Optional[int] = None,
                 mesh=None, device=None,
                 use_kernel: Optional[bool] = None,
                 graphs: Optional[bool] = None):
        if mesh is not None and mesh.data > 1:
            raise ValueError(
                f"Engine serves one replica; a mesh of data={mesh.data} "
                "replicas is served by serve.router.ReplicaRouter, one "
                "Engine a replica (router.local_replica_mesh)")
        if mesh is not None and device is not None and torch.device(
                device) not in (mesh.device, torch.device(mesh.device.type)):
            raise ValueError(f"device {device} is not the mesh's "
                             f"{mesh.device}")
        self.device = (mesh.device if mesh is not None
                       else resolve_device(device or "cuda"))
        self.cfg = cfg
        self.mesh = mesh if mesh is not None and mesh.model > 1 else None
        # The cache holds this rank's kv heads.
        self._kv_cfg = cfg
        if self.mesh is not None:
            self._kv_cfg = _local_cfg(cfg, mesh.model)
            params = shard_params(cfg, params, mesh)
        self.params = params
        self.max_slots = max_slots
        self.max_seq_len = max_seq_len
        self.cache_dtype = cache_dtype
        self.paged = paged
        self.use_kernel = (self.device.type == "cuda" if use_kernel is None
                           else use_kernel)
        capturable = self.mesh is None or self.mesh.group.capturable
        if (graphs is None and self.device.type == "cuda" and self.use_kernel
                and not capturable):
            warnings.warn(f"Engine: {self.mesh.group.backend} collectives "
                          "cannot be captured in a CUDA graph; the decode "
                          "steps run eagerly", RuntimeWarning, stacklevel=2)
        self.graphs = (self.device.type == "cuda" and self.use_kernel
                       and capturable if graphs is None else graphs)
        if self.graphs and self.device.type != "cuda":
            raise ValueError("graphs=True needs a CUDA device")
        if self.graphs and not capturable:
            raise ValueError(f"graphs=True: {self.mesh.group.backend} "
                             "collectives cannot be captured in a CUDA "
                             "graph")
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
                self._kv_cfg, self.total_pages, page_size, max_slots,
                self.max_pages, cache_dtype, device=self.device)
            self._free_pages: List[int] = list(range(1, self.total_pages))
            self._slot_pages: Dict[int, List[int]] = {}
        else:
            self.cache = init_kv_cache(self._kv_cfg, max_slots, max_seq_len,
                                       cache_dtype, device=self.device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        # When every active slot has >= fused_steps budget left and the
        # queue is drained, decode fused_steps tokens per host round trip.
        self.fused_steps = fused_steps
        # One decode-step runner a sampling mode, made at its first use.
        self.runners: Dict[str, DecodeGraph] = {}

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

    def _decode(self, k: int) -> np.ndarray:
        """``k`` decode steps of every slot through the runner of the
        slots' sampling mode; returns the tokens (slots, k) on the host.
        Slot state enters the runner's buffers by ``copy_`` and the tokens
        leave in one copy. Inactive slots decode at position 0: in slot
        mode they write garbage into their own rows (re-prefilled on
        admission), in paged mode into the trash page."""
        reqs = self.slot_req
        sampled = any(r and r.temperature > 0 for r in reqs)
        topkp = sampled and any(r and (r.top_k > 0 or r.top_p < 1.0)
                                for r in reqs)
        mode = "topkp" if topkp else "sample" if sampled else "greedy"
        run = self.runners.get(mode)
        if run is None:
            run = self.runners[mode] = DecodeGraph(
                self.cfg, self.params, self.max_slots,
                max(self.fused_steps, 1), mode, self.generator, self.device,
                self.use_kernel, self.graphs, self.mesh)
        pos = np.where([r is not None for r in reqs],
                       np.minimum(self.slot_pos, self.max_seq_len - 1), 0)
        run.last.copy_(torch.from_numpy(self.slot_last))
        run.pos.copy_(torch.from_numpy(pos.astype(np.int32)))
        if sampled:
            run.temps.copy_(torch.tensor(
                [r.temperature if r else 0.0 for r in reqs]))
            run.top_ks.copy_(torch.tensor([r.top_k if r else 0
                                           for r in reqs]))
            run.top_ps.copy_(torch.tensor([r.top_p if r else 1.0
                                           for r in reqs]))
        run.run(self.cache, k)
        return run.tokens[:, :k].cpu().numpy()

    def _step_fused(self, active, k: int) -> None:
        toks = self._decode(k)  # (slots, k)
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
            tmp_cache = init_kv_cache(self._kv_cfg, rows, bucket,
                                      self.cache_dtype, device=self.device)
            tokens = self._t(padded, torch.int64)
            if self.mesh is None:
                logits, tmp_cache = prefill(self.cfg, self.params, tokens,
                                            tmp_cache, self.use_kernel)
            else:
                logits, tmp_cache = tp_prefill(self.cfg, self.params, tokens,
                                               tmp_cache, self.mesh,
                                               self.use_kernel)
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
        if active:
            self._step_fused(active, 1)
