"""Whole-model quantization: calibrate -> per-layer solve -> packed params
(port of ``sleekit_tpu/models/quantize.py``).

:func:`calibrate` streams token batches through
:func:`~sleekit_tpu_torch.models.transformer.calibrate_step` (the
statistics accumulate on the model's device; over a mesh's data axis each
rank takes its rows of every batch and the ranks' statistics are merged),
:func:`calibrate_spill` sweeps layer by layer and keeps the statistics on
the host; :func:`quantize_model` runs
:func:`~sleekit_tpu_torch.pipeline.quantize_layer` for every linear and
stores either the dequantized f32 weights (reference semantics) or the
packed serving format; with ``layer_parallel`` the linears of one shape
are solved as stacks, in chunks that fit the device's memory, and over a
mesh each rank solves its block of every chunk.
:func:`pack_lm_head` packs the unembed head.
"""

from __future__ import annotations

import dataclasses
import os
import socket
import time
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from sleekit_tpu_torch.codebooks import UniformCodebook
from sleekit_tpu_torch.hessian import LayerStats, finalize_psum, init_stats
from sleekit_tpu_torch.models.transformer import (
    TransformerConfig, _block, _embed, _slopes, block_linear_names,
    calibrate_step, get_linear_param, init_calibration_stats, layer_names,
    set_linear_param)
from sleekit_tpu_torch.ops.pack import PackedLinear, pack_quantized
from sleekit_tpu_torch.pipeline import QuantConfig, quantize_layer
from sleekit_tpu_torch.scaling import compute_non_saturating_scaling


# Headroom the JAX package keeps for a solve's workspace (its own figures):
# at K = 8192, scaled by K^2, floored.
WORKSPACE_AT_8192 = 3.5e9
WORKSPACE_FLOOR = 0.5e9


def solve_workspace(k: int) -> float:
    """A solve's workspace estimate at input dimension ``k``."""
    return max(WORKSPACE_FLOOR, WORKSPACE_AT_8192 * (k / 8192.0) ** 2)


def hbm_limit(device) -> float:
    """The device's memory budget in bytes: ``QUANT_HBM_LIMIT`` if set (to
    exercise the spill and drain branches on a large card, or on the
    CPU), else the card's total memory."""
    env = os.environ.get("QUANT_HBM_LIMIT")
    if env:
        return float(env)
    return float(torch.cuda.mem_get_info(device)[1])


def chunk_size(dev, left: int, k: int, lane_bytes: float = 0.0,
               share: int = 1) -> int:
    """How many of the ``left`` same-shape solves at input dimension ``k``
    fit the device's memory at once (at least one): its budget
    (:func:`hbm_limit`) over the ``share`` processes that use the device,
    less what PyTorch holds there now in this one, over a lane's
    workspace estimate plus ``lane_bytes`` (its statistics, if they come
    from another device). Without a budget (the CPU, no
    ``QUANT_HBM_LIMIT``) all of them."""
    if dev.type != "cuda" and not os.environ.get("QUANT_HBM_LIMIT"):
        return left
    used = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0
    free = hbm_limit(dev) / share - used
    return max(1, min(left, int(free // (solve_workspace(k) + lane_bytes))))


@dataclasses.dataclass
class LayerReport:
    name: str
    error: float
    wall_s: float


def calibrate(cfg: TransformerConfig, params, batches: Iterable,
              stats: Optional[Dict[str, LayerStats]] = None, mesh=None
              ) -> Dict[str, LayerStats]:
    """Accumulate every linear's statistics over calibration batches of
    (B, T) tokens, on the model's device (through the kernels there if it
    is CUDA).

    With a ``mesh`` (``parallel.mesh.make_mesh``) of ``data > 1`` ranks,
    each holding the whole model, rank d takes the d-th contiguous block
    of every batch's rows (B must divide by ``data``), and the ranks'
    statistics are merged over the data axis at the end
    (:func:`~sleekit_tpu_torch.hessian.finalize_psum`): every rank returns
    the statistics of all the rows. Given ``stats`` are this rank's
    partial ones."""
    dev = params["embed"]["tokens"].device
    data = 1 if mesh is None else mesh.data
    if mesh is not None and mesh.model > 1:
        raise NotImplementedError(
            "calibrate over a mesh's model axis (statistics from a "
            "tensor-parallel forward) is not ported (ROADMAP, modules to "
            "port: tensor-parallel calibration)")
    if stats is None:
        stats = init_calibration_stats(cfg, dev)
    for tokens in batches:
        tokens = np.asarray(tokens)
        if tokens.shape[0] % data:
            raise ValueError(f"a batch of {tokens.shape[0]} rows does not "
                             f"split over data={data} ranks")
        rows = tokens.shape[0] // data
        if data > 1:
            tokens = tokens[mesh.data_rank * rows:(mesh.data_rank + 1) * rows]
        stats = calibrate_step(cfg, params,
                               torch.as_tensor(tokens, device=dev), stats)
    if data > 1:
        stats = {name: finalize_psum(st, mesh.data_group)
                 for name, st in stats.items()}
    return stats


def stats_to_host(st: LayerStats, pin: bool = False) -> LayerStats:
    """``st`` copied to the host (into page-locked memory with ``pin``, so
    that the copy back to the card can run asynchronously)."""
    def host(x):
        if not pin:
            return x.to("cpu")
        out = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        return out.copy_(x)
    return LayerStats(*(host(x) for x in (st.mean, st.hessian, st.count)))


def calibrate_spill(cfg: TransformerConfig, params, batches
                    ) -> Dict[str, LayerStats]:
    """Layer-outer calibration, for models whose statistics do not fit the
    device even without the solve's workspace.

    Every batch's activations stay on the model's device (small next to
    the Hessians); the sweep goes layer by layer, updates only that
    layer's statistics (batch by batch, in the order :func:`calibrate`
    does) and moves them to the host before the next layer. The device
    holds the params, the activations and one layer's statistics. Returns
    CPU statistics (page-locked when the model is on CUDA), equal to
    :func:`calibrate`'s: each layer's input is computed by the same ops."""
    dev = params["embed"]["tokens"].device
    use_kernel = dev.type == "cuda"
    dims = {"fc2": cfg.d_ff, "down": cfg.d_ff}
    slopes = _slopes(cfg, dev)
    xs, poss = [], []
    for tokens in batches:
        tokens = torch.as_tensor(np.asarray(tokens), device=dev)
        b, t = tokens.shape
        positions = torch.arange(t, device=dev).expand(b, t)
        poss.append(positions)
        xs.append(_embed(cfg, params, tokens, positions, use_kernel))

    host: Dict[str, LayerStats] = {}
    for i, layer in enumerate(params["layers"]):
        bstats = {f"layers.{i}.{n}": init_stats(dims.get(n, cfg.d_model), dev)
                  for n in block_linear_names(cfg)}
        for j, positions in enumerate(poss):
            xs[j] = _block(cfg, layer, xs[j], positions, None, slopes,
                           use_kernel, bstats, i)
        for name, st in bstats.items():
            host[name] = stats_to_host(st, pin=use_kernel)
        del bstats
    return host


def _layer_artifact_path(resume_dir: str, name: str) -> str:
    return os.path.join(resume_dir, name.replace(".", "_") + ".npz")


def _save_layer_artifact(resume_dir: str, name: str, Q, bias_delta, scale,
                         err) -> None:
    """Atomic per-layer checkpoint (tmp + rename): a stopped quantize_model
    resumes after the last completed layer. The JAX package writes the
    same file."""
    path = _layer_artifact_path(resume_dir, name)
    tmp = path + ".tmp.npz"
    arrays = dict(Q=Q, bias_delta=bias_delta, scale=scale, err=err)
    np.savez(tmp, **{k: v.detach().cpu().numpy() for k, v in arrays.items()})
    os.replace(tmp, path)


def _load_layer_artifact(resume_dir: str, name: str, device):
    path = _layer_artifact_path(resume_dir, name)
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        return tuple(torch.from_numpy(z[k]).to(device)
                     for k in ("Q", "bias_delta", "scale", "err"))


def _apply_solution(params, name, p, cb, Q, bias_delta, scale, qconfig,
                    pack, pack_host=False):
    bias = p.get("bias")
    if qconfig.bias_correction and bias is not None:
        bias = bias + bias_delta
    if pack and pack_host:
        # Packed on the CPU; the packed linear stays there.
        new_p = pack_quantized(Q.cpu(), scale.cpu(), cb,
                               bias=None if bias is None else bias.cpu())
    elif pack:
        new_p = pack_quantized(Q, scale, cb, bias=bias)
    else:
        new_p = {"kernel": Q.T.contiguous()}
        if bias is not None:
            new_p["bias"] = bias
    set_linear_param(params, name, new_p)


def _copy_tree(tree):
    """New dicts and lists over the same leaves."""
    if isinstance(tree, dict):
        return {k: _copy_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_copy_tree(v) for v in tree]
    return tree


def _to_device(st: LayerStats, dev) -> LayerStats:
    if st.hessian.device == dev:
        return st
    return LayerStats(*(x.to(dev, non_blocking=True)
                        for x in (st.mean, st.hessian, st.count)))


def quantize_model(cfg: TransformerConfig, params,
                   stats: Dict[str, LayerStats], qconfig: QuantConfig,
                   pack: bool = False, verbose: bool = False,
                   layer_parallel: bool = False, mesh=None,
                   resume_dir: Optional[str] = None, free_stats: bool = False,
                   pack_host: bool = False
                   ) -> Tuple[Any, List[LayerReport]]:
    """Quantize every linear layer of the model, on the device of its
    weights. Returns (new params, per-layer reports in layer order).

    ``pack=True`` makes the linears :class:`PackedLinear` (serving;
    ``pack_host``: packed on the CPU, where they stay); otherwise they
    hold the dequantized f32 weights. ``resume_dir`` saves each solved
    layer (atomic ``.npz``) and loads, instead of solving, every layer
    already there. ``free_stats`` pops each consumed entry from the
    caller's ``stats``. The smallest Hessians are solved first; statistics
    that live on another device (the host) are copied to the weights'
    device one layer ahead of their solve.

    ``layer_parallel=True`` groups the linears by shape and solves each
    group as stacks (one ``quantize_layer`` over L layers at once), in
    chunks that fit the device's memory (:func:`chunk_size`), the
    statistics copied to the device a chunk at a time; each report's
    ``wall_s`` is its chunk's wall over the chunk's size. A per-layer
    (lloyd) codebook stays serial, as in the JAX package.

    ``mesh`` (``parallel.mesh.make_mesh``, every rank holding the whole
    model and the same statistics) is read on the ``layer_parallel``
    route only, as in the JAX package; the serial route ignores it. Each
    chunk is padded to a multiple of the world's ranks by repeating its
    layers, rank r solves its r-th block and the solutions are
    all-gathered over ``mesh.world``: every rank returns the whole params
    and reports. The ranks agree on each chunk (one all-reduce: the
    smallest over the world of what fits each rank's share of its
    device), and only world rank 0 writes ``resume_dir``'s artifacts,
    which every rank reads."""
    if resume_dir is not None:
        os.makedirs(resume_dir, exist_ok=True)
    params = _copy_tree(params)
    per_layer_cb = qconfig.codebook_kind == "lloyd"
    explicit_cb = qconfig.codebook_kind != "uniform"
    cb = None if per_layer_cb else qconfig.make_codebook()
    names = layer_names(cfg)
    reports: Dict[str, LayerReport] = {}

    def finish(name, out, wall):
        Q, bias_delta, scale, err = out
        p = get_linear_param(params, name)
        cb_l = qconfig.make_codebook(p["kernel"].T) if per_layer_cb else cb
        _apply_solution(params, name, p, cb_l, Q, bias_delta, scale,
                        qconfig, pack, pack_host=pack_host)
        if free_stats:
            stats.pop(name, None)
        reports[name] = LayerReport(name=name, error=float(torch.sum(err)),
                                    wall_s=wall)
        if verbose:
            print(f"  {name:24s} err={reports[name].error:12.5g} "
                  f"{wall:6.2f}s", flush=True)

    def solved(name, out, wall, write=True):
        if resume_dir is not None and write:
            _save_layer_artifact(resume_dir, name, *out)
        finish(name, out, wall)

    pending = []
    for name in names:
        if resume_dir is not None:
            dev = get_linear_param(params, name)["kernel"].device
            got = _load_layer_artifact(resume_dir, name, dev)
            if got is not None:
                finish(name, got, 0.0)
                continue
        pending.append(name)
    # Smallest K first: the solve's workspace grows as K^2, and with
    # free_stats the resident statistics shrink as layers finish.
    pending.sort(key=lambda n: (stats[n].hessian.numel(), n))

    if layer_parallel and not per_layer_cb:
        world = None if mesh is None else mesh.world
        n_ranks = 1 if world is None else world.size
        share = 1 if n_ranks == 1 else _device_share(mesh.device, world)
        groups: Dict[Tuple[int, int], List[str]] = {}
        for name in pending:
            kernel = get_linear_param(params, name)["kernel"]    # (in, out)
            groups.setdefault((kernel.shape[1], kernel.shape[0]),
                              []).append(name)
        # Keyed (out, in): K = in first, then out.
        for (_, k), group in sorted(groups.items(),
                                    key=lambda kv: (kv[0][1], kv[0][0])):
            while group:
                t0 = time.perf_counter()
                dev = get_linear_param(params, group[0])["kernel"].device
                st = stats[group[0]]
                lane_bytes = (0.0 if st.hessian.device == dev else
                              (st.hessian.numel() + st.mean.numel()) * 4.0)
                per_rank = chunk_size(dev, -(-len(group) // n_ranks), k,
                                      lane_bytes, share)
                if n_ranks > 1:
                    per_rank = int(world.all_reduce(
                        torch.tensor([per_rank], device=mesh.device),
                        op=torch.distributed.ReduceOp.MIN).item())
                chunk = group[:per_rank * n_ranks]
                group = group[len(chunk):]
                outs = _solve_with_hbm_retry(
                    lambda chunk=chunk: _solve_layer_batch(
                        params, stats, chunk, qconfig,
                        cb if explicit_cb else None, mesh))
                wall = (time.perf_counter() - t0) / len(chunk)
                for name, out in zip(chunk, outs):
                    solved(name, out, wall, write=world is None
                           or world.rank == 0)
                # The chunk's stacks, before the next chunk's free memory
                # is read.
                del outs, out
        if n_ranks > 1 and resume_dir is not None:
            # Rank 0's artifacts are written before any rank reads them.
            world.barrier()
        pending = []

    prefetched: Dict[str, LayerStats] = {}
    for idx, name in enumerate(pending):
        t0 = time.perf_counter()
        p = get_linear_param(params, name)
        W = p["kernel"].T  # (out, in), the quantizer's layout
        dev = W.device
        st = prefetched.pop(name, None) or _to_device(stats[name], dev)
        if idx + 1 < len(pending):
            nxt = pending[idx + 1]
            prefetched[nxt] = _to_device(stats[nxt], dev)
        cb_solve = (qconfig.make_codebook(W) if per_layer_cb
                    else (cb if explicit_cb else None))

        def solve():
            out = quantize_layer(W, st.hessian, st.mean, qconfig, cb_solve)
            sync_device(dev)
            return out

        out = _solve_with_hbm_retry(solve)
        del st
        solved(name, out, time.perf_counter() - t0)
    return params, [reports[name] for name in names]


def sync_device(dev) -> None:
    """Wait for the work queued on ``dev`` (a no-op on the CPU)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _device_share(dev: torch.device, world) -> int:
    """How many ranks of ``world`` use ``dev`` on this host (one
    all-gather of (host, device) names): their memory budgets divide
    it."""
    mine = (socket.gethostname(), str(dev))
    every = [None] * world.size
    torch.distributed.all_gather_object(every, mine, group=world.pg)
    return sum(e == mine for e in every)


def _solve_stack(params, stats, names: List[str], qconfig: QuantConfig,
                 codebook):
    """One ``quantize_layer`` over the stacked weights, Hessians and means
    of ``names`` (same-shape linears), on the weights' device: each
    layer's statistics are copied into the stack from wherever they live
    (over a mesh, the counterpart of ``stats_specs``: every rank holds all
    the statistics and copies its block's). Returns the stacked (Q,
    bias_delta, scale, err)."""
    kernels = [get_linear_param(params, n)["kernel"] for n in names]
    dev = kernels[0].device
    n_in, n_out = kernels[0].shape
    L = len(names)
    Ws = torch.empty((L, n_out, n_in), device=dev)
    Hs = torch.empty((L, n_in, n_in), device=dev)
    mus = torch.empty((L, n_in), device=dev)
    for i, (name, kernel) in enumerate(zip(names, kernels)):
        Ws[i].copy_(kernel.T)
        Hs[i].copy_(stats[name].hessian, non_blocking=True)
        mus[i].copy_(stats[name].mean, non_blocking=True)
    out = quantize_layer(Ws, Hs, mus, qconfig, codebook)
    del Ws, Hs, mus
    sync_device(dev)
    return out


def _solve_layer_batch(params, stats, group: List[str], qconfig: QuantConfig,
                       codebook, mesh=None):
    """The solutions of ``group`` (same-shape linears), one (Q,
    bias_delta, scale, err) a layer in ``group``'s order: one stacked
    solve on this device, or over a mesh of several ranks, this rank's
    block of the group padded to a multiple of the ranks (layer i % L),
    and the blocks' solutions all-gathered over ``mesh.world``."""
    world = None if mesh is None else mesh.world
    L = len(group)
    if world is None or world.size == 1:
        out = _solve_stack(params, stats, group, qconfig, codebook)
    else:
        padded = [group[i % L] for i in range(L + (-L) % world.size)]
        per = len(padded) // world.size
        block = padded[world.rank * per:(world.rank + 1) * per]
        out = [world.all_gather(x, dim=0)[:L] for x in _solve_stack(
            params, stats, block, qconfig, codebook)]
    Q, bd, sc, err = out
    return [(Q[i], bd[i], sc[i], err[i]) for i in range(L)]


def _solve_with_hbm_retry(fn, attempts: int = 8, wait_s: float = 20.0):
    """Run a solve, retrying on ``torch.cuda.OutOfMemoryError``: a solve
    can lose the device memory to statistics still being moved off it,
    and waiting is exact (nothing in a solve depends on timing). A real
    shortage still raises after the last attempt."""
    for attempt in range(attempts):
        try:
            return fn()
        except torch.cuda.OutOfMemoryError:
            if attempt == attempts - 1:
                raise
            print(f"  solve ran out of device memory; waiting {wait_s:.0f}s "
                  f"({attempt + 1}/{attempts - 1})", flush=True)
            time.sleep(wait_s)


def quantize_model_from_batches(cfg: TransformerConfig, params,
                                batches: Iterable, qconfig: QuantConfig,
                                pack: bool = False, verbose: bool = False):
    """Calibrate, then quantize, in one call."""
    stats = calibrate(cfg, params, batches)
    return quantize_model(cfg, params, stats, qconfig, pack=pack,
                          verbose=verbose)


def pack_lm_head(cfg: TransformerConfig, params, nbits: int = 8):
    """Inject a packed serving unembed head: round-to-nearest with
    per-vocab-channel non-saturating scales (int8 'int8' layout by
    default; padded vocab columns get scale 0). The tied embedding gather
    keeps the dense table. Packs on the device the weights live on."""
    params = dict(params)
    if "lm_head" in params and not isinstance(params["lm_head"],
                                              PackedLinear):
        W = params["lm_head"]["kernel"].T          # (V, E)
    else:
        W = params["embed"]["tokens"]               # (V, E) tied
        if "project_out" in params["embed"]:
            raise ValueError("pack_lm_head does not support project_out "
                             "models (OPT-350M); unembed stays dense")
    W = W.float()
    cb = UniformCodebook(2 ** nbits, -1.0, 1.0)
    scale = compute_non_saturating_scaling(W, cb)   # per vocab channel
    Q = cb(W / scale[:, None]) * scale[:, None]
    params["lm_head"] = pack_quantized(Q, scale, cb)
    return params
