"""Per-decode-step collective accounting for tensor-parallel serving (port
of ``sleekit_tpu/parallel/comm_model.py``, plain Python).

Counts the collectives one ``tp_decode_step`` issues (two all-reduces a
layer, after the row-parallel o and fc2/down projections, plus one
all-gather of the vocab-sharded logits; ``parallel/tp_decode.py``),
converts them to wire bytes under the ring cost of 2*(n-1)/n bytes a
device an all-reduce, and sets them against the step time that the
packed weight stream dictates. First-order terms only: it shows where
tensor parallelism pays and where it stops paying, not milliseconds to
three digits. :class:`~sleekit_tpu_torch.parallel.distributed.TPGroup`
counts what a step really issues, and the tests hold the two equal.
"""

from __future__ import annotations

from typing import Dict


# H100 SXM: 3.35 TB/s of HBM3 and 900 GB/s of NVLink a card, 450 GB/s each
# way (NVIDIA's data sheet). Across hosts one 400 Gb/s NIC a card (50 GB/s),
# an assumption about the cluster.
HBM_BPS = 3.35e12
LINK_BPS = 4.5e11
CROSS_HOST_BPS = 5.0e10
# A step's time that its weight bytes leave out: the port's int4 OPT-1.3B
# batch-8 decode step on one H100 (1.632 ms, PERF.md section 5) less its
# bytes bound (0.28 ms).
STEP_OVERHEAD_S = 1.35e-3
# A collective's latency within a host and across hosts: assumptions, not
# measured (NCCL's small all-reduce over NVLink takes some microseconds).
ALLREDUCE_LATENCY_S = 1e-5
CROSS_HOST_LATENCY_S = 3e-5


def decode_step_comm(cfg, batch: int, tp: int, act_bytes: int = 2,
                     vocab_gather: bool = True) -> Dict[str, float]:
    """Collective calls and wire bytes of ONE decode step of ``cfg`` under
    ``tp``-way tensor parallelism (batch ``batch``, activations
    ``act_bytes`` wide): two all-reduces a layer of a (batch, d_model)
    activation, and one all-gather of the (batch, vocab/tp) logit shards
    when the model has an lm_head (``vocab_gather``)."""
    n_ar = 2 * cfg.n_layers + (1 if vocab_gather else 0)
    ar_payload = batch * cfg.d_model * act_bytes
    # Ring all-reduce: each device sends and receives 2*(n-1)/n of the
    # payload; an all-gather moves (n-1)/n of the gathered result.
    ring = 2.0 * (tp - 1) / tp
    ar_bytes = 2 * cfg.n_layers * ar_payload * ring
    ag_bytes = 0.0
    if vocab_gather:
        ag_bytes = batch * cfg.vocab_size * act_bytes * (tp - 1) / tp
    return {
        "allreduce_calls": n_ar,
        "allreduce_payload_bytes": float(ar_payload),
        "link_bytes_per_step": float(ar_bytes + ag_bytes),
        "tp": tp,
    }


def packed_weight_bytes(cfg, nbits: int) -> float:
    """Approximate packed-weight stream of one decode step: every linear at
    nbits/8 bytes a weight, and an int8 unembed."""
    d, f, v = cfg.d_model, cfg.d_ff, cfg.vocab_size
    kv_dim = d * cfg.kv_heads // cfg.n_heads
    per_layer = d * (d + 2 * kv_dim) + d * d          # qkv + o
    glu = cfg.activation in ("silu_glu", "swiglu")
    per_layer += d * f * (3 if glu else 2)            # up(+gate) + down
    return cfg.n_layers * per_layer * nbits / 8.0 + d * v


def tp_step_estimate(cfg, batch: int, tp: int, nbits: int = 4,
                     cross_host: bool = False,
                     kv_bytes_per_step: float = 0.0) -> Dict[str, float]:
    """First-order step time under ``tp``-way tensor parallelism:

    step = (weights + kv) / tp / HBM + overhead
         + collective bytes / link + calls * latency

    with the speed-up over one card and its efficiency against linear, at
    the same batch."""
    comm = decode_step_comm(cfg, batch, tp)
    w_bytes = packed_weight_bytes(cfg, nbits)
    t1 = (w_bytes + kv_bytes_per_step) / HBM_BPS + STEP_OVERHEAD_S
    link = CROSS_HOST_BPS if cross_host else LINK_BPS
    lat = CROSS_HOST_LATENCY_S if cross_host else ALLREDUCE_LATENCY_S
    t_comm = comm["link_bytes_per_step"] / link + comm["allreduce_calls"] * lat
    t_tp = ((w_bytes + kv_bytes_per_step) / tp / HBM_BPS
            + STEP_OVERHEAD_S + t_comm)
    return {
        **comm,
        "weight_bytes": w_bytes,
        "t_single_s": t1,
        "t_tp_s": t_tp,
        "t_comm_s": t_comm,
        "tokens_per_s_speedup": t1 / t_tp,
        "efficiency_vs_linear": t1 / t_tp / tp,
    }


def two_host_recipe(cfg, batch: int, tp: int, nbits: int = 4) -> str:
    """The layout the byte accounting supports for two hosts: the model
    axis inside each host (NVLink), hosts on the data axis, which carries
    no serving collective; so the single-host tensor-parallel efficiency
    is the constraint."""
    est = tp_step_estimate(cfg, batch, tp, nbits)
    return (f"2-host config: mesh data=2 (hosts, network) x model={tp} "
            f"(NVLink); per-step cross-host collective bytes = 0 (serving), "
            f"NVLink {est['link_bytes_per_step'] / 1e6:.2f} MB/step in "
            f"{est['allreduce_calls']} all-reduces; single-host TP{tp} "
            f"comm time {est['t_comm_s'] * 1e3:.2f} ms vs weight-stream "
            f"{est['weight_bytes'] / tp / HBM_BPS * 1e3:.2f} ms")
