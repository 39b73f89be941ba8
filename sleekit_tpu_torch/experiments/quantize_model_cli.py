"""End-user CLI: quantize a whole model to a packed serving checkpoint
(port of ``sleekit_tpu/experiments/quantize_model_cli.py``).

  python -m sleekit_tpu_torch.experiments.quantize_model_cli out_ckpt/ \\
      --model opt-125m [--checkpoint /path/to/hf] [--preset light] \\
      [--nbits 4] [--tokens tokens.npy] [--samples 16] [--pack/--no-pack] \\
      [--device cuda|cpu]

Calibrates, quantizes every linear with the chosen preset, reports the
per-layer errors and wall clock, optionally scores perplexity before and
after, and saves the packed checkpoint (skq2) for the serving engine. It
runs on the CUDA device unless ``--device cpu`` is given.

On the card, or on any device when ``QUANT_HBM_LIMIT`` gives a budget in
bytes, the statistics' placement follows the device's memory (the card's
total from ``torch.cuda.mem_get_info`` unless the variable overrides it):
layer-outer calibration with host statistics
(``calibrate_spill``) when they do not fit even without a solve's
workspace; otherwise statistics on the device, with the largest shed to
the host by a background drain when the simulated solve peak does not fit
(``--offload-stats auto``), all of them moved first with ``always``, none
with ``never``. The decisions are the plain functions :func:`spill_needed`
and :func:`offload_plan`; their constants are the JAX package's own
headroom figures.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from sleekit_tpu_torch.models.quantize import (
    hbm_limit, solve_workspace, sync_device)

# Headroom the JAX package keeps (its own figures): over the calibration
# footprint before it spills, and over the simulated solve peak (the
# solve's workspace estimate is ``models/quantize.py``'s).
SPILL_HEADROOM = 1.5e9
PEAK_MARGIN = 0.5e9
DRAIN_GROUP_BYTES = 2e9


# ---- the device-memory decisions (plain functions of sizes) ---------------


def est_stats_bytes(cfg) -> float:
    """The statistics' bytes for ``cfg`` without allocating them: f32
    (K, K) Hessian and (K,) mean per linear (the JAX package's formula)."""
    from sleekit_tpu_torch.models.transformer import layer_names

    d, ff = cfg.d_model, cfg.d_ff
    dim_of = {"q": d, "k": d, "v": d, "o": d, "fc1": d, "fc2": ff,
              "gate": d, "up": d, "down": ff}
    return sum(4.0 * (dim_of[n.split(".")[-1]] ** 2
                      + 2 * dim_of[n.split(".")[-1]])
               for n in layer_names(cfg))


def tree_bytes(tree) -> int:
    """Bytes of every tensor in a tree of dicts, lists, dataclasses
    (``LayerStats``, ``PackedLinear``) and tensors."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    if dataclasses.is_dataclass(tree):
        return sum(tree_bytes(getattr(tree, f.name))
                   for f in dataclasses.fields(tree))
    return 0


def spill_needed(params_bytes: float, stats_bytes: float,
                 limit: float) -> bool:
    """Whether calibration must sweep layer-outer with host statistics:
    params and statistics do not fit with the calibration headroom."""
    return params_bytes + stats_bytes + SPILL_HEADROOM > limit


def offload_plan(entries: Sequence[Tuple[str, int, int]],
                 params_bytes: float, limit: float, mode: str) -> dict:
    """Where the statistics live during the solves. ``entries``: (name, K,
    bytes) of each statistics entry in calibration order. The solve loop
    takes the smallest K first and frees each entry when its layer is
    solved, so the peak is the largest, over that order, of params +
    the entries left + that layer's workspace. Returns ``peak``, the
    ``action`` ('always': move every entry to the host first; 'shed': a
    background drain of ``shed``, the largest entries, until the peak
    with two of them back on the device fits; 'none') and ``shed_bytes``.
    """
    order = sorted(entries, key=lambda e: e[1])     # stable: ties in order
    s_rem = float(sum(e[2] for e in order))
    peak = 0.0
    for _, k, nbytes in order:
        peak = max(peak, params_bytes + s_rem + solve_workspace(k))
        s_rem -= nbytes
    plan = dict(peak=peak, action="none", shed=[], shed_bytes=0.0)
    if mode == "always":
        plan["action"] = "always"
    elif mode == "auto" and peak + PEAK_MARGIN > limit:
        shed, shed_bytes, max_shed = [], 0.0, 0.0
        for name, _, nbytes in reversed(order):     # largest first
            # Up to two shed entries are back on the device during their
            # own solves (the current one and the prefetched next).
            if peak + PEAK_MARGIN - shed_bytes + 2 * max_shed <= limit:
                break
            shed_bytes += nbytes
            max_shed = max(max_shed, nbytes)
            shed.append(name)
        plan.update(action="shed", shed=shed, shed_bytes=shed_bytes)
    return plan


# ---- the background drain ---------------------------------------------------


class StatsTable(dict):
    """The statistics dict that the solve loop and the background drain
    share. The solve loop's ``pop`` (``free_stats``) and the drain's
    write-back take one lock, and the drain writes back only entries still
    present, so an entry freed by its solve is never put back."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.lock = threading.Lock()

    def pop(self, name, *default):
        with self.lock:
            return super().pop(name, *default)

    def replace_present(self, values: Dict[str, object]) -> List[str]:
        """Write back the entries of ``values`` still in the table;
        returns their names."""
        with self.lock:
            kept = [n for n in values if n in self]
            for n in kept:
                self[n] = values[n]
        return kept


def drain(stats: StatsTable, shed: Sequence[str], to_host,
          group_bytes: float = DRAIN_GROUP_BYTES) -> List[str]:
    """Move the ``shed`` entries of ``stats`` to the host with ``to_host``
    (one entry's copy) in groups of about ``group_bytes``, each group
    written back as it lands, so that the device frees memory group by
    group. Entries the solve loop has already freed are skipped or
    dropped. Returns the names moved."""
    moved: List[str] = []
    group: Dict[str, object] = {}
    nbytes = 0.0

    def flush():
        nonlocal group, nbytes
        if group:
            moved.extend(stats.replace_present(
                {n: to_host(st) for n, st in group.items()}))
        group, nbytes = {}, 0.0

    for name in shed:
        st = stats.get(name)
        if st is None:
            continue
        group[name] = st
        nbytes += tree_bytes(st)
        if nbytes >= group_bytes:
            flush()
    flush()
    return moved


def card_to_host(device):
    """``to_host`` for :func:`drain` on the card: each entry copied into
    page-locked host memory on a stream of its own (off the solve loop's),
    the calling thread waiting for that stream only."""
    from sleekit_tpu_torch.hessian import LayerStats

    stream = torch.cuda.Stream(device)
    stream.wait_stream(torch.cuda.default_stream(device))

    def to_host(st):
        with torch.cuda.stream(stream):
            out = []
            for x in (st.mean, st.hessian, st.count):
                h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
                h.copy_(x, non_blocking=True)
                out.append(h)
        stream.synchronize()
        return LayerStats(*out)
    return to_host


def _tree_to(tree, dev):
    """Every tensor of a params tree on ``dev``."""
    from sleekit_tpu_torch.ops.pack import PackedLinear

    if isinstance(tree, torch.Tensor):
        return tree.to(dev)
    if isinstance(tree, PackedLinear):
        return dataclasses.replace(
            tree, **{f: _tree_to(getattr(tree, f), dev)
                     for f in ("packed", "scale", "lut", "bias")})
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, dev) for v in tree]
    return tree


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Quantize a model to a packed serving checkpoint")
    parser.add_argument("out", type=str)
    parser.add_argument("--model", type=str, default="tiny")
    parser.add_argument("--checkpoint", type=str, default=None,
                        help="HF checkpoint dir (default: random init)")
    parser.add_argument("--preset", type=str, default="light",
                        choices=["basic", "light", "heavy"])
    parser.add_argument("--nbits", type=float, default=4)
    parser.add_argument("--codebook", type=str, default="uniform",
                        choices=["uniform", "nf4", "lloyd"])
    parser.add_argument("--grid-size", type=int, default=100)
    parser.add_argument("--obq-refine", type=int, default=0,
                        help="coarse-then-fine OBQ scaling: 2N sweeps "
                             "instead of grid-size (heavy preset only; "
                             "see scaling.compute_obq_scaling caveats)")
    parser.add_argument("--tokens", type=str, default=None,
                        help=".npy int32 token stream, .skt shard, or "
                             "'wikitext2' (needs HF datasets+tokenizer); "
                             "default synthetic")
    parser.add_argument("--samples", type=int, default=16)
    parser.add_argument("--seq-len", type=int, default=256)
    parser.add_argument("--batch", type=int, default=2)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--eval-ppl", action="store_true",
                        help="Report perplexity before/after on held-out "
                             "tokens")
    parser.add_argument("--no-pack", dest="pack", action="store_false")
    parser.add_argument("--offload-stats", type=str, default="auto",
                        choices=["auto", "always", "never"],
                        help="Move calibration Hessians to host RAM before "
                             "the solve loop (auto: only when stats+params "
                             "exceed the device memory budget)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    from sleekit_tpu_torch.device import resolve_device
    from sleekit_tpu_torch.models.data import (
        calibration_batches, load_token_stream)
    from sleekit_tpu_torch.models.eval import (
        chunk_tokens, decode_perplexity, perplexity)
    from sleekit_tpu_torch.models.quantize import (
        calibrate, calibrate_spill, quantize_model, stats_to_host)
    from sleekit_tpu_torch.models.transformer import init_params
    from sleekit_tpu_torch.models.zoo import get_config
    from sleekit_tpu_torch.pipeline import preset_config
    from sleekit_tpu_torch.serve.checkpoint import save_packed_params
    from sleekit_tpu_torch.utils.profiling import Timer

    dev = resolve_device(args.device)
    cfg = get_config(args.model)
    if args.checkpoint:
        from sleekit_tpu_torch.models.hf import load_hf_checkpoint
        params = load_hf_checkpoint(cfg, args.model, args.checkpoint,
                                    device=dev)
    else:
        params = init_params(cfg, seed=args.seed, device=dev)

    need = args.samples * args.seq_len + 4096
    stream, provenance = load_token_stream(
        args.tokens, cfg.vocab_size, need, seed=args.seed)
    print(f"calibration tokens: {provenance}")
    batches = calibration_batches(stream, args.samples, args.seq_len,
                                  args.batch)

    qconfig = preset_config(args.preset, nbits=args.nbits,
                            codebook_kind=args.codebook,
                            grid_size=args.grid_size,
                            obq_refine=args.obq_refine)
    timer = Timer()
    result = dict(spill=False, offload="none", shed=[], peak=None)
    on_card = dev.type == "cuda"
    budgeted = on_card or bool(os.environ.get("QUANT_HBM_LIMIT"))
    if budgeted:
        # Statistics that do not fit the device even without a solve's
        # workspace would exhaust it during calibration itself: sweep
        # layer-outer and keep each layer's statistics on the host.
        p_bytes, s_bytes = tree_bytes(params), est_stats_bytes(cfg)
        result["spill"] = spill_needed(p_bytes, s_bytes, hbm_limit(dev))
    with timer.section("calibrate"):
        if result["spill"]:
            print(f"stats+params estimate {(p_bytes + s_bytes) / 1e9:.2f} GB "
                  "exceeds HBM: "
                  "layer-outer SPILL calibration (host-resident stats)",
                  flush=True)
            stats = calibrate_spill(cfg, params, batches)
        else:
            stats = calibrate(cfg, params, batches)
        sync_device(dev)
    stats = StatsTable(stats)
    drainer: Optional[threading.Thread] = None
    if budgeted and not result["spill"]:
        # Move statistics to the host only when the footprint demands it:
        # with free_stats and smallest-K-first solves the steady peak is
        # params + the statistics left + one solve's workspace.
        limit = hbm_limit(dev)
        plan = offload_plan(
            [(n, st.hessian.shape[-1], tree_bytes(st))
             for n, st in stats.items()], p_bytes, limit,
            args.offload_stats)
        peak = plan["peak"]
        result.update(offload=plan["action"], shed=plan["shed"], peak=peak)
        if plan["action"] == "always":
            with timer.section("stats_offload"):
                for n in list(stats):
                    stats[n] = stats_to_host(stats[n], pin=on_card)
            print(f"stats offloaded to host ({tree_bytes(stats) / 1e9:.2f}"
                  " GB, --offload-stats=always)", flush=True)
        elif plan["action"] == "shed":
            # Shed the largest statistics to the host in a background
            # thread, overlapped with the solves: the solve loop uses an
            # entry still on the device directly and copies host entries
            # back one layer ahead.
            to_host = card_to_host(dev) if on_card else stats_to_host
            drainer = threading.Thread(
                target=drain, args=(stats, plan["shed"], to_host),
                daemon=True)
            with timer.section("stats_offload"):
                drainer.start()
            print(f"background offload started: {len(plan['shed'])}/"
                  f"{len(stats)} stats entries "
                  f"({plan['shed_bytes'] / 1e9:.2f} GB) draining "
                  f"under the solves (simulated peak {peak / 1e9:.2f} GB "
                  f"> HBM {limit / 1e9:.2f} GB)", flush=True)
        else:
            resident = tree_bytes(stats) + p_bytes
            print(f"stats+params {resident / 1e9:.2f} GB on device; "
                  f"simulated solve peak {peak / 1e9:.2f} GB fits HBM "
                  f"{limit / 1e9:.2f} GB - no offload", flush=True)
    with timer.section("quantize"):
        qparams, reports = quantize_model(cfg, params, stats, qconfig,
                                          pack=args.pack, verbose=True,
                                          free_stats=True,
                                          pack_host=result["spill"])
        sync_device(dev)
    if drainer is not None:
        drainer.join()
    result["stats_left"] = sorted(stats)
    with timer.section("save"):
        save_packed_params(args.out, qparams, meta={
            "model": args.model, "preset": args.preset,
            "nbits": args.nbits, "codebook": args.codebook})

    total_err = sum(r.error for r in reports)
    print(f"\n{len(reports)} layers quantized; total layer error "
          f"{total_err:.6g}")
    result.update(reports=reports, total_error=total_err, ppl=None)
    if args.eval_ppl:
        if result["spill"]:
            qparams = _tree_to(qparams, dev)    # packed on the host
        held = stream[args.samples * args.seq_len:]
        ev = list(chunk_tokens(held, args.seq_len, args.batch))
        with timer.section("eval_ppl"):
            # fp32 / quantized forward / quantized through the decode path
            # (the serving kernels' route). The last two agree by
            # contract; disagreement means a serving kernel drifted from
            # the pipeline.
            ppl_ref = perplexity(cfg, params, ev, device=dev)
            ppl_q = perplexity(cfg, qparams, ev, device=dev)
            ppl_dec = decode_perplexity(cfg, qparams, ev, device=dev)
        print(f"perplexity: fp32 {ppl_ref:.4f} -> quantized {ppl_q:.4f} "
              f"(delta {ppl_q - ppl_ref:+.4f}); decode-scored "
              f"{ppl_dec:.4f} (forward-vs-decode "
              f"{ppl_dec - ppl_q:+.5f})")
        warned = abs(ppl_dec - ppl_q) > 0.01
        if warned:
            print("WARNING: packed decode path disagrees with the "
                  "fake-quant forward by more than 0.01 ppl", flush=True)
        result["ppl"] = dict(fp32=ppl_ref, quantized=ppl_q, decode=ppl_dec,
                             warned=warned)
    print(timer.dump())
    print(f"checkpoint -> {args.out}")
    result.update(timer=timer.report(), out=args.out)
    return result


if __name__ == "__main__":
    main()
