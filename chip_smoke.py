"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. builds the port's CUDA kernels (K1-K15, K8f, K9f) from
   ``sleekit_tpu_torch/csrc``, one nvcc per source, all at once, and
   prints the build's time and ptxas's registers and spills of
   K1/K6/K7's decode kernel (``pair_stream_kernel``), of the main path's
   ``decode_kernel`` instantiations (K3 over the slot cache, K5 over the
   pool: bf16 q, int8 cache, bf16 scales), of the 4-bit 'plane'
   instantiations of both routes that the NF4 (K8) and int4 'plane' (K9)
   paths run, of the 4-bit f32 'plane' instantiations of both routes
   (K8f's table and K9f's grid, ``stream_tf32_kernel`` at M <= 8 and
   ``f32_tile_kernel`` above), of the main path's ``append_kernel``
   instantiations (K10 at prefill and T = 1) and of K4's f32
   ``prefill_tf32_kernel`` at each padded head dim (no spill allowed);
2. holds each kernel against its plain PyTorch version on the card at the
   shapes OPT-1.3B serving gives it, and times the kernel, the plain
   version and, where one exists, one PyTorch library call computing the
   same function (a yardstick the port never calls) with CUDA events; K2
   (the int8 head) at M = 8 (its streaming route), 64 and 1024 (its
   tensor-core route); K4 (causal flash prefill, bf16 on the tensor
   cores) at OPT-1.3B's 256-bucket group, at BLOOM-560m's with ALiBi and
   at llama3-8b's GQA over a 1024-token prompt, and its f32 route
   (split-TF32 on the tensor cores) in the same three cases with f32
   inputs (within 1e-5 of the largest output, timed beside SDPA in f32 and
   both bounds, f32 and split TF32), and at large logits (q and k of mean
   1 and 3, ALiBi at T 1024) its distance from the plain version and from
   the exact answer, no further from the latter than 1.5x the plain
   version's own; K10 over a prompt's rows
   (the prefill's KV write: int8 rows, bf16 scales and the dequantized
   K/V) at the 256-bucket group's and llama3-8b's shapes, bit for bit
   with its plain version (the PyTorch path it replaced, timed beside
   it), and at one row (B 1, KV 1), the launch floor. The page-pool
   kernels (K5, K14, K15) run over a strided, out-of-order table
   of distinct 64-row pages; K5 is held bit for bit to K3 on the same
   logical rows, and K13 (the batch-folded flash decode) to K11; K12 (the
   f32 elementwise flash decode) is held within one bf16 step of its plain
   version, a bound that K11's bf16 numerics are shown to miss;
3. serves 8 greedy requests of 32 new tokens through the port's slot
   Engine with OPT-1.3B at full width and depth (random int4 'pair'
   weights from a seed, fused q|k|v, int8 head, int8 KV cache with bf16
   scales) on the graph route (each decode step a replayed CUDA graph,
   ``models/eval.py`` ``DecodeGraph``), with the time its prefills take,
   checks the run's launches through the replay accounting (each replay
   counts the captured step's 96 K1, 1 K2 and 24 K3; K10 once a layer in
   each prefill) and the launches of one decode step, serves the same
   requests on the eager route (``graphs=False``): the same tokens, bit
   for bit, with each route's wall, prefill and decode seconds and
   tokens/s, then once more under ``torch.profiler`` (trace under the
   git-ignored ``traces/engine``: the card's busy share of a run); checks
   the prefill
   logits against the kernels' plain versions on the card (bf16
   tolerance through the first layer, relative L2 through all of them)
   and one decode step's logits from two copies of the Engine's cache
   likewise (relative L2 of 2^-6 through all layers, argmax agreement
   measured), and times a full-depth prefill of the 256-bucket group (4
   x 256) and batch-8 decode: 32 steps of the decode loop eager and as
   graph replays, and one step's device time as a graph;
4. serves the same requests through the paged Engine (page pool of 64-row
   pages), on the graph route: run A on the default pool emits the slot
   Engine's tokens, and its eager route's, and launches 96 K1, 1 K2 and
   24 K5 (no K3) per decode step; run B on a
   17-page pool blocks admission and recycles pages; decode through a
   pool holding the slot cache's rows gives the slot cache's logits, bit
   for bit, its logits against the plain versions' as in 3, and it is
   timed as in 3;
5. takes one decode step on each split route (FLASH_FUSED_APPEND off)
   over the slot cache - 24 K10 + 24 K11; with FLASH_MHA_MODE 'ew' 24 K12;
   with FLASH_BATCH_FOLD 24 K13; with both, K12 - and over the pool (24
   K14 + 24 K15), within the bf16 tolerance of the fused route's logits
   through one layer and a relative L2 of 2^-6 through 24, each step timed
   as a CUDA graph; then serves the prompts of 3 (16 new tokens) through
   the slot Engine on the 'ew' split route (24 K10 + 24 K12 a step, the
   graph captured with those knobs), its decode logits held as in 3;
   then serves them sampled (temperature 0.8, top-k 40, top-p 0.9, a
   seeded generator) on the graph and the eager route: the same tokens;
6. holds K6 ('pair3x'), K7 ('pair3'), K8 (NF4 'plane') and K9 (uniform
   int4 'plane') against their plain versions on the four projections of
   an OPT-1.3B layer at M = 8, 64 and 1024, timed as in 2 (K1 too, in 2);
   and K8f (NF4; the 8-bit affine grid at M = 8 and 512) and K9f
   (uniform int4) with f32 x at M = 1, 2, 4, 8, 512 and 2048, and at fc2 with
   x >= 0 (as after the relu) at M = 512 and 2048, within 1e-5 of the
   largest |output| of their plain versions (at x >= 0, where their f32
   product is itself off by more than that, of the same function with
   the product exact, rounded once to f32), timed as in 2 beside the
   plain version, a ``torch.matmul`` of x by the dequantized f32 weight
   and the bound: the operations at the faster of the two
   f32-accurate rates (the CUDA cores' f32, or the tensor cores' TF32
   over the split's three products, two for K9f), or the bytes;
7. serves the same 8 prompts through the slot Engine with the int3
   'pair3x' model, the same indices repacked as 'pair3', and an NF4
   'plane' model, all at full width and depth (16 new tokens each), on
   the graph route (NF4 on the eager route too: the same tokens): one
   decode step launches exactly 96 K6, K7 or K8, 1 K2 and 24 K3 (no K1);
   prefill logits, kernels vs plain versions, as in 3 (NF4's random model
   drifts: its full depth is measured, and held on the same indices over
   its table minus its mean; its decode logits likewise only measured),
   the decode logits as in 3, and each of the 24 layers on the same input
   within the bf16 tolerance; the pair3
   logits against the pair3x ones; prefill and batch-8 decode timed as
   in 3. Then
   repacks the int4 model's indices as 'plane' (uniform codebook): its
   prefill logits against the 'pair' model's, its layers one by one, and
   decode steps with 96 K9 each; then scores the int4 model's
   ``perplexity`` and ``decode_perplexity`` (2 x 256 synthetic tokens; the
   latter on the decode loop's graph) and holds them within PPL_RTOL;
8. runs the decode-side benches at OPT-1.3B, briefly: ``attn_bench`` under
   each flash-decode schedule (K11, K12, K13), ``profile_decode``'s split
   of the int4 'pair' step at positions 272-287 (the last 16 rows of a
   288-row cache, inside the ctx 256-288 at which 3 times decode; with a
   ``torch.profiler`` trace written under the git-ignored
   ``traces/profile_decode``; its residual must be positive), the same
   split of the NF4 'plane' step (K8; trace under
   ``traces/profile_decode_nf4``), and the attn_only variant on the 'ew'
   and batch-folded split routes,
   ``kernel_bench`` on the four decode shapes, and ``prefill_bench`` on
   the int4 model's 256-bucket group (with a trace of one prefill under
   ``traces/prefill``, which must show 24 K10 and no PyTorch quantizer
   op): its matmul section (K1 int4 'pair' and K7 int3 'pair3' against
   dequantize + ``torch.matmul`` and ``torch.matmul`` on the bf16 weight,
   at fc1 and the fused q|k|v, M = 8, 128, 512, 2048: every form within
   the bf16 tolerance of the f32 product; ms, MFU and the crossover
   printed) and its attention-route A/B (``--modes ours,xla``: the 'xla'
   route's prefill logits within a relative L2 of 2^-6 of K4's); their
   result lines go to stdout;
9. runs the quantizer on dense bf16 OPT-1.3B at full width (random
   weights from seed 0, its first 2 layers: the CLI phase solves all 24):
   calibrates on the JAX CLI's defaults (16 x 256 tokens of
   ``synthetic_stream``, batch 2; exactly 32 K4 launches), quantizes its
   12 linears (light, 4 bits, packed; a resume directory in the temporary
   directory, removed after), then resumes from it
   (nothing solved: the dequantized dense model of the same solve, to
   which every packed linear dequantizes within 1e-6);
   scores round-to-nearest, basic, light and heavy on layer 0's six
   linears (each GPTQ-based error below round-to-nearest's); holds
   layer 0's fc1 on the card against the CPU (objective within 1e-3, 99%
   of the codewords equal); serves the packed model (q|k|v fused, int8
   head) as 3 serves the int4 model, and holds its prefill logits to the
   dequantized dense model's (relative L2 <= 2^-6); solves the same 12
   linears again with ``layer_parallel=True`` (each shape group as stacks
   in chunks that fit the card, no kernel launched), both routes' wall
   seconds, chunk sizes and peak memory printed: every layer's error
   within rel 1e-4 of the serial route's and at least 99% of its packed
   codewords equal, and that packed model served as the serial one is
   (its greedy tokens equal to the serial model's where every word is);
   and profiles one fc2 solve and the batched route's fc2 chunk (traces
   under the git-ignored ``traces/quantize_fc2`` and
   ``traces/quantize_fc2_chunk``): device time by phase, launches a
   column and the card's busy share;
10. runs the user's two commands (``experiments/quantize_model_cli.py``
   and ``serve_cli.py``) as a user does, on f32 OPT-1.3B at full width
   (random weights from seed 0, nothing downloaded): writes its HF-layout
   checkpoint (``facebook/opt-1.3b``'s keys, F16, two safetensors shards
   and their index) into the temporary directory, holds
   ``load_hf_checkpoint`` to the init weights rounded to f16, bit for bit,
   and ``calibrate_spill`` to ``calibrate`` (max |diff| 0); writes the
   CLI's calibration stream as an SKT1 shard (the native loader's
   ``write_shard``), reads it back through ``load_token_stream`` (the
   native ``TokenShard.windows``) bit for bit, and gives it to every
   quantize run below as ``--tokens`` (one shard read a run); quantizes it
   with ``--codebook nf4 --eval-ppl`` at full depth (light, 4 bits: 192
   K4 launches in calibration, 144 linears solved once, all NF4 'plane'
   on reload; the scorings' launches counted, K8f 144 a forward batch
   and 144 a decode step, replay-counted, and ``dequant_matmul_ref``
   raising for a 'plane' linear on the card; ``decode_perplexity``
   within PPL_RTOL of ``perplexity``; the card's peak memory); serves
   that checkpoint with ``serve_cli`` (int8 KV, 8 x 256-token prompts,
   32 new tokens), slot and ``--paged``: the launches replay-counted (K3
   or K5 24 a step, K4 and K10 24 a prefill group, K8f 144 a step and a
   prefill group, nothing else), the cold and steady runs' greedy tokens
   equal, slot and paged equal, and the slot run's prefill and decode
   logits, kernels vs plain versions, within a relative L2 of 1e-5
   through layer 1 (measured through 24); then at 2 layers (CLI_DEPTH)
   quantizes with ``--codebook lloyd --eval-ppl`` (the same checks), and
   with the uniform codebook (int4 'pair', ``--eval-ppl`` on the plain
   route at f32), serves that checkpoint with ``serve_cli`` (K3 or K5, K4
   and K10 only) and on the bf16 main path as 3 does (K1, K2, K3, K4,
   K10), repacks its indices as 'plane' and scores ``perplexity`` on K9f
   (24 a batch) within 1e-5 relative of the 'pair' weights on the plain
   route, and runs the CLI twice more with a ``QUANT_HBM_LIMIT`` computed
   from the CLI's own estimates: once spilling (``calibrate_spill``, host
   statistics, ``pack_host``) and once shedding the largest statistics to
   a background drain; each run's packed words bit for bit the uniform
   run's, no statistics left behind;
11. runs the reference's ablation CLIs (``experiments/{dump_stats,
   compare,bits,scaling,correction,ordering,dampening,local_search,
   distribution,results}.py``): ``dump_stats`` writes OPT-125m's 72
   linears (full width and depth, random weights from seed 0, the JAX
   CLI's defaults) into the temporary directory, every Hessian finite;
   each analysis CLI runs over layer 0's linears but fc2 (ABLATION_SKIP;
   fc2's shape is solved in 9 and 10) (``bits`` at grid 5,
   the others at 10, ``scaling`` with every ``--run-*`` flag) with the
   JAX CLIs' headers, finite values, local search never raising the
   error and 5 bits below 1 bit; ``distribution --save-data`` and
   ``results`` on compare's table; each CLI's seconds printed;
12. serves tensor-parallel (``parallel/``): holds K1 on one rank's q,
   o, fc1 and fc2 shards of a two-way split layer (o and fc2 over
   ``split_packed_k`` rows, without bias or residual), K2 on one vocab
   shard and K3 at 16 local heads against their plain versions, timed as
   in 2; runs ``tp_decode_step`` over a world-1 NCCL group at OPT-1.3B
   (full width and depth, unfused int4 'pair', int8 head, int8 KV with
   bf16 scales, batch 8): its logits within a relative L2 of 2^-6 of the
   single-device kernel step's, the step captured in a CUDA graph with
   its 48 all-reduces and replayed bit for bit as the eager step, then 32
   greedy steps of ``DecodeGraph`` over the mesh (graph tokens = eager
   tokens, launches and all-reduces counted from the replays, timed
   beside the single-device unfused graph loop); then two spawned ranks
   on this one card over gloo serve the model split two ways: 4 x 256
   prompts through ``tp_prefill``, 32 eager greedy steps, both ranks'
   tokens equal, logits within 2^-6 of the single-device kernels', each
   rank's 6 K1, 1 K3 (at prefill K4 and K10) and 2 all-reduces a layer
   and 1 K2 and 1 all-gather a step counted exactly (its times measure
   two ranks sharing a card through the host's gloo, not TP's speed);
13. runs the data axis (``serve/router.py``, ``calibrate(mesh=)``,
   ``quantize_model(mesh=)``): a ``ReplicaRouter`` over two replicas on
   this card in one process serves step 3's model and prompts, slot and
   paged (request i on replica i % 2, each replica's tokens those of a
   standalone Engine fed its requests, bit for bit, its launches
   replay-counted: 96 K1, 1 K2 and 24 K3 or K5 a step); then two spawned
   gloo ranks on this card, ``make_mesh(data=2, model=1)``, each serve
   their replica (the same tokens, no collective on the data axis while
   serving), run ``calibrate(mesh=)`` at the quantize step's 2 layers of
   bf16 OPT-1.3B (counts equal to the single process's, statistics
   within DP_STATS_RTOL) and ``quantize_model(layer_parallel=True,
   pack=True, mesh=)`` (both ranks' words equal; held by the batched
   route's gates to the single process's batched route on the same
   statistics, and by DP_PIPELINE_*_RTOL on error to it on its own);
14. runs ``tools/gpu_kernel_smoke.py`` at its full geometries: every
   kernel at every layout, bit width and geometry of the JAX tool's
   matrix (8B-class K 4096 and 14336 with the layernorm prologue, GQA
   decode at G = 4), at M = 8 and 64 and with f32 x where JAX sends it,
   each case within 2e-2 of a dense f32 oracle and within its plain
   version's tolerance, naming the kernels it launched (summary in the
   git-ignored ``chiprun_out/gpu_kernel_smoke.json``);
15. prints each phase's wall seconds, the kernels line (K1-K15, K8f and
   K9f, with ``quantize``, ``cli``, ``ablation``, ``tp``, ``data_axis``,
   ``kernel_smoke`` and ``phases`` entries beside ``engine``), the card's
   name and power limit, and, last, the result line.

Any failure raises; there is no CPU branch and no fallback. It needs a
CUDA device and exits non-zero without one.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import io
import json
import math
import multiprocessing
import os
import queue
import re
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from sleekit_tpu_torch import kernels  # noqa: E402
from sleekit_tpu_torch.codebooks import Codebook, UniformCodebook  # noqa: E402
from sleekit_tpu_torch.experiments import (  # noqa: E402
    attn_bench, bits, compare, correction, dampening, distribution,
    dump_stats, kernel_bench, local_search, ordering, prefill_bench,
    profile_decode, quantize_model_cli, results, scaling, serve_cli)
from sleekit_tpu_torch.experiments.quantize_model_cli import (  # noqa: E402
    SPILL_HEADROOM, est_stats_bytes, offload_plan, spill_needed, tree_bytes)
from sleekit_tpu_torch import pipeline as pipe_mod  # noqa: E402
from sleekit_tpu_torch import solver as solver_mod  # noqa: E402
from sleekit_tpu_torch.hessian import remove_input_bias  # noqa: E402
from sleekit_tpu_torch.models.data import (  # noqa: E402
    calibration_batches, load_token_stream, synthetic_stream)
from sleekit_tpu_torch.native.dataio import (  # noqa: E402
    TokenShard, write_shard)
from sleekit_tpu_torch.models import eval as eval_mod  # noqa: E402
from sleekit_tpu_torch.models.eval import (  # noqa: E402
    DecodeGraph, chunk_tokens, decode_perplexity, decode_scan, perplexity)
from sleekit_tpu_torch.models.fake_quant import random_packed_params  # noqa: E402
from sleekit_tpu_torch.models.hf import load_hf_checkpoint  # noqa: E402
from sleekit_tpu_torch.models import quantize as quant_mod  # noqa: E402
from sleekit_tpu_torch.models.quantize import (  # noqa: E402
    calibrate, calibrate_spill, pack_lm_head, quantize_model)
from sleekit_tpu_torch.models import transformer as tr  # noqa: E402
from sleekit_tpu_torch.models.transformer import (  # noqa: E402
    decode_step, init_kv_cache, prefill)
from sleekit_tpu_torch.models import zoo  # noqa: E402
from sleekit_tpu_torch.models.zoo import opt_1b3  # noqa: E402
from sleekit_tpu_torch.ops import attention as attn  # noqa: E402
from sleekit_tpu_torch.ops import dequant_matmul as dm  # noqa: E402
from sleekit_tpu_torch.ops import paged_attention as paged  # noqa: E402
from sleekit_tpu_torch.ops.attention import (  # noqa: E402
    K3, K4, K10, K11, K12, K13)
from sleekit_tpu_torch.ops.dequant_matmul import (  # noqa: E402
    K1, K2, K6, K7, K8, K8f, K9, K9f)
from sleekit_tpu_torch.ops.pack import (  # noqa: E402
    PackedLinear, pack_indices, unpack_indices)
from sleekit_tpu_torch.ops.paged_attention import K5, K14, K15  # noqa: E402
from sleekit_tpu_torch.pipeline import (  # noqa: E402
    preset_config, quantize_layer)
from sleekit_tpu_torch.scaling import (  # noqa: E402
    compute_non_saturating_scaling)
from sleekit_tpu_torch.solver import channelwise_error  # noqa: E402
from sleekit_tpu_torch.serve import engine as engine_mod  # noqa: E402
from sleekit_tpu_torch.serve.checkpoint import load_packed_params  # noqa: E402
from sleekit_tpu_torch.serve.engine import Engine, Request  # noqa: E402
from sleekit_tpu_torch.serve.router import (  # noqa: E402
    ReplicaRouter, local_replica_mesh, replica_meshes)
from sleekit_tpu_torch.parallel.distributed import (  # noqa: E402
    init_process_group)
from sleekit_tpu_torch.parallel.mesh import (  # noqa: E402
    make_mesh, prepare_params_for_tp, shard_params)
from sleekit_tpu_torch.parallel.tp_decode import (  # noqa: E402
    _local_cfg as tp_local_cfg, tp_decode_step, tp_prefill)
from sleekit_tpu_torch.utils.profiling import (  # noqa: E402
    cuda_ms, device_trace, trace_summary)

# Published H100 SXM peaks (NVIDIA data sheet, dense): device memory rate
# and the bf16 tensor-core rate.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
# The f32 rate outside the tensor cores and the dense TF32 tensor-core
# rate (same data sheet).
F32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12
L2_BYTES = 50 * 2 ** 20


def log(*a):
    print(*a, flush=True)


def pair_rule(name: str) -> str:
    """The tile rule of a ``pair_stream_kernel`` instantiation, read from
    its mangled name: Pair<NB>, Pair3, Pair3x."""
    rule = re.search(r"Pair3x|Pair3|PairILi(\d+)E", name)
    return (rule.group(0) if rule and not rule.group(1)
            else f"Pair<{rule.group(1)}>" if rule else name)


def decode_rule(name: str):
    """The main path's ``decode_kernel`` instantiations, read from the
    mangled name: bf16 q, int8 cache, bf16 scales, FUSED_APPEND, one query
    head a pass, head dim 64 - K3 over the slot cache, K5 over the pool;
    None for the others."""
    m = re.search(r"decode_kernelI13__nv_bfloat16aS\d*_Lb1ELi0ELb([01])"
                  r"ELi1ELi64EE", name)
    return None if m is None else ("K3 slot", "K5 pool")[int(m.group(1))]


def plane_rule(name: str):
    """The 4-bit 'plane' instantiations of the two routes, read from the
    mangled name: "K8 stream" (Plane<4, true>: the NF4 table), "K9 mma
    4x4x2" (Plane<4, false>, WM x WN x MINB), ...; None for the others."""
    m = re.search(r"PlaneILi4ELb([01])EEE(?:Li(\d+)ELi(\d+)ELi(\d+)E)?",
                  name)
    if m is None:
        return None
    kern = "K8" if m.group(1) == "1" else "K9"
    return (f"{kern} mma {m.group(2)}x{m.group(3)}x{m.group(4)}"
            if m.group(2) else f"{kern} stream")


def f32_rule(name: str):
    """The 4-bit instantiations of K8f/K9f's two routes
    (``csrc/plane_f32.cu``), read from the mangled name: "K8f stream
    TOK=4" (``stream_tf32_kernel<4, true, 4>``: the NF4 table, mma.sync
    at M <= 4 with x's hi and lo in one n8), "K9f tile"
    (``f32_tile_kernel<4, false>``), ...; None for the others."""
    m = re.search(r"stream_tf32_kernelILi4ELb([01])ELi(\d)E", name)
    if m is not None:
        kern = "K8f" if m.group(1) == "1" else "K9f"
        return f"{kern} stream TOK={m.group(2)}"
    m = re.search(r"f32_tile_kernelILi4ELb([01])E", name)
    if m is None:
        return None
    return ("K8f" if m.group(1) == "1" else "K9f") + " tile"


def k4_f32_rule(name: str):
    """K4's f32 instantiations (``prefill_tf32_kernel<DP>``), read from the
    mangled name: "K4 f32 DP=64", ...; None for the others."""
    m = re.search(r"prefill_tf32_kernelILi(\d+)E", name)
    return None if m is None else f"K4 f32 DP={m.group(1)}"


def append_rule(name: str):
    """The main path's ``append_kernel`` instantiations, read from the
    mangled name: bf16 rows into an int8 cache with bf16 scales, one chunk
    a lane of 8 elements (the prefill's 16-byte loads) or of 2 (T = 1 at
    D 64); None for the others."""
    m = re.search(r"append_kernelI13__nv_bfloat16aS\d*_Lb1ELi([28])ELi1EE",
                  name)
    return None if m is None else {"8": "K10 prefill", "2": "K10/K14 T=1"}[
        m.group(1)]


def ptxas_report(build_log: str, kernel: str, rule=pair_rule):
    """{instantiation: [registers, spill store bytes, spill load bytes]}
    of each entry named ``kernel`` in nvcc's ``-Xptxas -v`` output, keyed
    by ``rule`` of its mangled name (None: left out)."""
    out = {}
    for part in build_log.split("Compiling entry function '")[1:]:
        name = part.split("'")[0]
        if kernel not in name:
            continue
        key = rule(name)
        if key is None:
            continue
        regs = re.search(r"Used (\d+) registers", part)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", part)
        out[key] = [int(regs.group(1)) if regs else None,
                    *(map(int, spill.groups()) if spill else (None, None))]
    return out


def copies_for(nbytes: int) -> int:
    """Argument sets needed to exceed twice the L2 size."""
    return max(1, min(32, math.ceil(2 * L2_BYTES / max(nbytes, 1))))


def bound(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def bf16_check(got, ref, what):
    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    tol = 2 ** -6 * ref.abs() + 1e-2 * ref.abs().max()
    if not torch.isfinite(got).all() or bool((err > tol).any()):
        raise AssertionError(f"{what}: max |err| {err.max().item():.4g} over "
                             f"the bf16 tolerance (rtol 2^-6, atol "
                             f"{1e-2 * ref.abs().max().item():.4g})")
    return err.max().item()


def ulp_misses(got, ref):
    """Elements more than one bf16 step (rtol 2^-7) plus 2^-14 max|ref|
    away: the bound for two f32 computations of one function, each
    rounded to bf16 once, at the end."""
    got, ref = got.float(), ref.float()
    tol = 2 ** -7 * ref.abs() + 2 ** -14 * ref.abs().max()
    return int(((got - ref).abs() > tol).sum().item())


# ---- phase 2: each kernel at the slice's shapes -----------------------------


# The dequant-matmul kernels and the layout of their words: 4-bit 'pair'
# and 'plane', 3-bit 'pair3x' and 'pair3'.
LINEAR_LAYOUTS = {"K1": "pair", "K6": "pair3x", "K7": "pair3", "K8": "plane",
                  "K9": "plane"}


def layout_rows(layout, K):
    """Word rows of K rows in ``layout``."""
    return {"pair3x": K // 512 * 56, "pair3": -(-K // 256) * 24,
            "pair": -(-K // 256) * 32, "plane": -(-K // 256) * 32}[layout]


def layout_words(dev, gd, layout, K, N):
    """Random words of a (K, N) matrix (for 'pair3x', the top bit of each
    4-bit field 0)."""
    w = torch.randint(-2 ** 31, 2 ** 31, (layout_rows(layout, K), N),
                      dtype=torch.int64, device=dev, generator=gd
                      ).to(torch.int32)
    if layout == "pair3x":
        w.view(-1, 56, N)[:, :32] &= 0x77777777
    return w


def check_linears(dev, cfg, names, tp=1):
    """Dequant-matmul kernels ``names`` on the four projections of a
    layer: K1 (int4 'pair'), K6 ('pair3x') and K7 ('pair3') with their
    prologues and residuals, K8 (the NF4 table) and K9 (the uniform int4
    grid) on 'plane' words with none (the model composes them), at decode
    M = 8, at M = 64 (the Engine's most common prefill: 4 rows of the
    16 bucket, 1 row of the 64 bucket) and at the largest prefill M (4
    rows of the 256 bucket). With ``tp``, one rank's shards of a
    tensor-parallel layer instead: q and fc1 on a 1/tp of the columns with
    the norm, o and fc2 on a 1/tp of the rows with neither bias nor
    residual (added after the all-reduce), at the two-rank phase's decode
    M = 4 and prefill M = 1024.
    Yardstick: ``torch.matmul`` on a bf16 weight of the same shape."""
    gd = torch.Generator(device=dev).manual_seed(len(names) + tp)
    d, ff = cfg.d_model, cfg.d_ff
    shapes = [("qkv", d, 3 * d, "layernorm", False),
              ("o", d, d, None, True),
              ("fc1", d, ff, "layernorm", False),
              ("fc2", ff, d, "relu", True)]
    sizes, tag = (8, 64, 1024), ""
    if tp > 1:
        shapes = [("q", d, d // tp, "layernorm", False),
                  ("o", d // tp, d, None, False),
                  ("fc1", d, ff // tp, "layernorm", False),
                  ("fc2", ff // tp, d, "relu", False)]
        sizes, tag = (TP_BATCH, TP_BATCH * TP_PROMPT), f"tp{tp} "
    nf4 = Codebook.nf4().values.to(dev)
    cases = {}
    for kern in names:
        layout = LINEAR_LAYOUTS[kern]
        cases[kern] = []
        for m in sizes:
            for name, K, N, pre, res in shapes:
                if layout == "plane":
                    pre, res = None, False
                nbits = 3 if layout in ("pair3", "pair3x") else 4
                kw_rows = layout_rows(layout, K)
                n_copy = copies_for(kw_rows * N * 4 + K * N * 2)
                words = [layout_words(dev, gd, layout, K, N)
                         for _ in range(n_copy)]
                scale = 0.02 + 0.002 * torch.rand(N, device=dev, generator=gd)
                bias = 0.01 * torch.randn(N, device=dev, generator=gd)
                if tp > 1 and name in ("o", "fc2"):
                    bias = None
                x = torch.randn(m, K, device=dev, generator=gd).to(
                    torch.bfloat16)
                kw = {}
                if kern in ("K1", "K6", "K7"):
                    if kern == "K1":
                        fn, plain = dm.pair_matmul, dm.pair_matmul_plain
                        kw = dict(nbits=4, a_aff=2.0 / 15 * 16,
                                  b_aff=-1.0 - 32 / 15)
                    else:
                        fn, plain = dm.pair3_matmul, dm.pair3_matmul_plain
                        kw = dict(a_aff=4 * 2.0 / 7, layout=layout,
                                  b_aff=-1.0 if layout == "pair3x"
                                  else -1.0 - 12 * 2.0 / 7)
                    kw.update(k=K, pre=pre, eps=1e-5)
                    if pre == "layernorm":
                        kw["ln_scale"] = torch.ones(K, dtype=torch.bfloat16,
                                                    device=dev)
                        kw["ln_bias"] = torch.zeros(K, dtype=torch.bfloat16,
                                                    device=dev)
                    if res:
                        kw["residual"] = torch.randn(
                            m, N, device=dev, generator=gd).to(torch.bfloat16)
                    extra = ()
                elif kern == "K8":
                    fn, plain = dm.plane_lut_matmul, dm.plane_lut_matmul_plain
                    kw = dict(nbits=4, k=K)
                    extra = (nf4,)
                else:
                    fn, plain = (dm.plane_affine_matmul,
                                 dm.plane_affine_matmul_plain)
                    kw = dict(nbits=4, k=K, a_aff=2.0 / 15 * 16,
                              b_aff=-1.0 - 32 / 15)
                    extra = ()

                def call(f, i, words=words, scale=scale, bias=bias, x=x,
                         kw=kw, extra=extra):
                    return f(x, words[i], scale, bias, *extra, **kw)
                got, want = call(fn, 0), call(plain, 0)
                torch.cuda.synchronize()
                err = bf16_check(got, want, f"{kern} {tag}{name} M={m}")
                ms = cuda_ms(lambda i: call(fn, i), n_copy)
                plain_ms = cuda_ms(lambda i: call(plain, i), n_copy, iters=5,
                                   warmup=1, graph=False)
                xp = dm._prologue_plain(x, pre, kw.get("ln_scale"),
                                        kw.get("ln_bias"), 1e-5, K)
                wdeq = [unpack_indices(w, nbits, K, layout).to(torch.bfloat16)
                        for w in words]
                lib_ms = cuda_ms(lambda i: torch.matmul(xp, wdeq[i]), n_copy)
                del wdeq
                nbytes = (x.numel() * 2 + kw_rows * N * 4
                          + (1 if bias is None else 2) * N * 4 + m * N * 2
                          + (2 * K * 2 if pre == "layernorm" else 0)
                          + (m * N * 2 if res else 0)
                          + (16 * 4 if kern == "K8" else 0))
                b_ms, b_by = bound(nbytes, 2.0 * m * K * N)
                cases[kern].append(dict(
                    case=f"{tag}{name} M={m}", max_abs_err=err, ms=ms,
                    plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                    bound_by=b_by, bytes=nbytes))
                log(f"{kern} {tag}{name:4s} M={m:5d} K={K} N={N}: err "
                    f"{err:.3g} "
                    f"| kernel {ms:.4f} ms plain {plain_ms:.3f} ms matmul "
                    f"{lib_ms:.4f} ms bound {b_ms:.4f} ms ({b_by})")
                del words
    return cases


# K8f/K9f's M on the f32 path: decode_perplexity's batch 2, serve_cli's
# 8 slots, eval_ppl's forward (2 x 256) and serve_cli's 8 x 256 prefill;
# and the streaming route at 1 and 4 tokens (its n8 partly zero).
F32_MS = (2, 8, 512, 2048)
F32_DECODE_MS = (1, 4)


def f32_bound(nbytes: float, flops: float, products: int):
    """(bound ms, bound_by, ops ms on the CUDA cores at f32, ops ms on the
    tensor cores over the split's ``products`` TF32 products): the least
    time of the two f32-accurate routes' operations, or of the bytes."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_f32 = flops / F32_FLOP_PER_S * 1e3
    t_tf32 = products * flops / TF32_FLOP_PER_S * 1e3
    t_ops = min(t_f32, t_tf32)
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", t_f32, t_tf32)


def check_linears_f32(dev, cfg):
    """K8f (the NF4 table; the 8-bit affine grid at M = 8 and 512) and K9f
    (the uniform int4 grid) on random 'plane' words of the four
    projections of an OPT-1.3B layer, with f32 x, at F32_MS and
    F32_DECODE_MS, and on fc2
    with x >= 0 (as after the relu, the worst case for a sum's bias) at
    M = 512 and 2048: within 1e-5 of the largest |output| of the plain
    version (f32, the table unrounded; the plain product with TF32 off)
    or, at x >= 0, where that f32 product is itself more than 1e-5 off, of
    the same function with the product taken exactly (f64, rounded once
    to f32; the plain version's distance from it reported), timed as
    check_linears times (CUDA-graph replays over rotating copies), beside
    the plain version and one ``torch.matmul`` of x by the dequantized
    f32 weight (TF32 off). The bound is the larger of the
    bytes over 3.35 TB/s and the operations at the faster f32-accurate
    route: the f32 rate outside the tensor cores, or the TF32 rate over
    the tiled route's split products (3 for K8f, 2 for K9f; one TF32
    product misses 1e-5)."""
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("K8f/K9f: the plain product must run without "
                             "TF32")
    gd = torch.Generator(device=dev).manual_seed(16)
    d, ff = cfg.d_model, cfg.d_ff
    shapes = [("qkv", d, 3 * d), ("o", d, d), ("fc1", d, ff),
              ("fc2", ff, d)]
    nf4 = Codebook.nf4().values.to(dev)
    grid8 = (2.0 / 255, -1.0)
    grid, pos = " (8-bit grid)", " (x >= 0)"
    runs = [("K8f", "", m, shapes) for m in F32_MS + F32_DECODE_MS]
    runs += [("K8f", grid, m, shapes) for m in (8, 512)]
    runs += [("K9f", "", m, shapes) for m in F32_MS + F32_DECODE_MS]
    runs += [(kern, pos, m, shapes[3:]) for kern in ("K8f", "K9f")
             for m in (512, 2048)]
    cases = {"K8f": [], "K9f": []}
    for kern, label, m, run_shapes in runs:
        for name, K, N in run_shapes:
            nbits = 8 if label == grid else 4
            kw_rows = -(-K // (32 * (32 // nbits))) * 32
            n_copy = copies_for(kw_rows * N * 4 + m * K * 4)
            words = [torch.randint(-2 ** 31, 2 ** 31, (kw_rows, N),
                                   dtype=torch.int64, device=dev,
                                   generator=gd).to(torch.int32)
                     for _ in range(n_copy)]
            scale = 0.02 + 0.002 * torch.rand(N, device=dev, generator=gd)
            bias = 0.01 * torch.randn(N, device=dev, generator=gd)
            x = torch.randn(m, K, device=dev, generator=gd)
            if label == pos:
                x = x.abs()
            if kern == "K8f":
                fn, plain = dm.plane_lut_matmul, dm.plane_lut_matmul_plain
                kw = dict(nbits=nbits, k=K,
                          affine=grid8 if label == grid else None)
                extra = (nf4,)
                table = dm._k8_table(nf4, nbits, kw["affine"],
                                     rounded=False).to(dev)
            else:
                fn, plain = (dm.plane_affine_matmul,
                             dm.plane_affine_matmul_plain)
                kw = dict(nbits=4, k=K, a_aff=2.0 / 15 * 16,
                          b_aff=-1.0 - 32 / 15)
                extra = ()
                table = torch.linspace(-1.0, 1.0, 16, device=dev)

            def call(f, i, words=words, scale=scale, bias=bias, x=x, kw=kw,
                     extra=extra):
                return f(x, words[i], scale, bias, *extra, **kw)
            kernel = dm.K8f if kern == "K8f" else dm.K9f
            before = kernel.launches
            got = call(fn, 0)
            want = call(plain, 0)
            torch.cuda.synchronize()
            if kernel.launches != before + 1:
                raise AssertionError(f"{kern}: a call did not launch it")
            # x >= 0 over fc2's K: the plain version's f32 product is itself
            # more than 1e-5 off, so the kernel is held to the plain
            # version's function with the product (and K9f's row sums)
            # taken exactly, rounded once to f32; how far the plain version
            # is from that is reported.
            f32_err = None
            if label == pos:
                idx = unpack_indices(words[0], nbits, K, "plane").long()
                xd = x.double()
                if kern == "K8f":
                    exact = (xd @ table.double()[idx]).float() * scale + bias
                else:
                    c = idx.double() / 16 - 0.5
                    exact = (kw["a_aff"] * (xd @ c).float() + dm._centred(
                        kw["a_aff"], kw["b_aff"], "plane")
                        * xd.sum(dim=1, keepdim=True).float()) * scale + bias
                f32_err = ((want - exact).abs().max().item()
                           / exact.abs().max().item())
                want = exact
                del idx, xd, exact
            err = (got - want).abs().max().item()
            top = want.abs().max().item()
            what = f"{kern} {name} M={m}{label}"
            if (got.dtype != torch.float32 or not torch.isfinite(got).all()
                    or not err <= 1e-5 * top):
                raise AssertionError(f"{what}: max |err| {err:.3g} over 1e-5 "
                                     f"of the largest output {top:.3g}")
            ms = cuda_ms(lambda i: call(fn, i), n_copy)
            plain_ms = cuda_ms(lambda i: call(plain, i), n_copy, iters=5,
                               warmup=1, graph=False)
            del words[1:]
            lib_copy = copies_for(K * N * 4)
            wdeq = [table[unpack_indices(
                torch.randint(-2 ** 31, 2 ** 31, (kw_rows, N),
                              dtype=torch.int64, device=dev,
                              generator=gd).to(torch.int32),
                nbits, K, "plane").long()] * scale for _ in range(lib_copy)]
            lib_ms = cuda_ms(lambda i: torch.matmul(x, wdeq[i]), lib_copy)
            del wdeq, words
            nbytes = (m * K * 4 + kw_rows * N * 4 + 2 * N * 4 + m * N * 4
                      + (16 * 4 if kern == "K8f" and label != grid else 0))
            flops = 2.0 * m * K * N
            b_ms, b_by, f32_ms, tf32_ms = f32_bound(
                nbytes, flops, 3 if kern == "K8f" else 2)
            plan = (dm.f32_tile_plan(m, N, K, dm._sms(0))
                    if m > dm.DECODE_M else
                    dm.f32_stream_plan(N, kw_rows, nbits, dm._sms(0))[1])
            cases[kern].append(dict(
                case=f"{name} M={m}{label}", max_abs_err=err,
                rel_err=err / top, ms=ms, plain_ms=plain_ms,
                library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                f32_ops_ms=f32_ms, tf32_ops_ms=tf32_ms, k_splits=plan,
                f32_product_rel_err=f32_err, bytes=nbytes, flops=flops))
            log(f"{kern} {name:4s} M={m:5d} K={K} N={N}{label}: err "
                f"{err:.3g} ({err / top:.3g} of max) | kernel {ms:.4f} ms "
                f"plain {plain_ms:.3f} ms matmul f32 {lib_ms:.4f} ms bound "
                f"{b_ms:.4f} ms ({b_by}; ops at f32 "
                f"{F32_FLOP_PER_S / 1e12:.0f} TFLOP/s {f32_ms:.4f} ms, split "
                f"TF32 {TF32_FLOP_PER_S / 1e12:.0f} TFLOP/s {tf32_ms:.4f} ms:"
                f" {'split TF32' if tf32_ms < f32_ms else 'f32'} bounds)"
                + f" K splits {plan}"
                + (f"; held to the exact product, which the plain version "
                   f"misses by {f32_err:.3g} of max" if f32_err is not None
                   else ""))
    for kern, cs in cases.items():
        for m, label in [(m, "") for m in sorted(F32_MS + F32_DECODE_MS)] + [
                (8, grid), (512, grid)]:
            mc = [c for c in cs if c["case"].endswith(f" M={m}{label}")]
            if not mc:
                continue

            def total(key, mc=mc):
                return sum(c[key] for c in mc)
            log(f"{kern} one layer's four projections at M={m}{label}: "
                f"kernel {total('ms'):.4f} ms, plain {total('plain_ms'):.3f}"
                f" ms, matmul f32 {total('library_ms'):.4f} ms, bound "
                f"{total('bound_ms'):.4f} ms (ops at f32 "
                f"{total('f32_ops_ms'):.4f} ms, split TF32 "
                f"{total('tf32_ops_ms'):.4f} ms; {total('bytes')} bytes)")
    return cases


def check_k2(dev, g, cfg, tp=1):
    """K2 on the int8 head (OPT-1.3B: 2048 x 51200 for vocab 50272) with
    the final layernorm prologue, at decode M = 8 (the streaming route),
    at M = 64 (the Engine's most common prefill) and at M = 1024 (the
    256-bucket group; both on the tensor-core route). With ``tp``, rank
    0's vocab shard (1/tp of the padded width, all of it the vocabulary's)
    at the two-rank phase's M = 4 and 1024. Yardstick: ``torch.matmul``
    of the bf16 pre(x) with the bf16 head."""
    K, V = cfg.d_model, cfg.vocab_size
    Np = -(-V // 1024) * 1024
    sizes, tag = (8, 64, 1024), ""
    if tp > 1:
        Np = V = Np // tp
        sizes, tag = (TP_BATCH, TP_BATCH * TP_PROMPT), f"tp{tp} "
    packed = torch.randint(-128, 128, (K, Np), dtype=torch.int8,
                           generator=g).to(dev)
    scale = (0.001 * torch.rand(Np, generator=g)).to(dev)
    kw = dict(k=K, out_n=V, a_aff=2.0 / 255, b_aff=-1.0 + 128 * 2.0 / 255,
              pre="layernorm", eps=1e-5,
              ln_scale=torch.ones(K, dtype=torch.bfloat16, device=dev),
              ln_bias=torch.zeros(K, dtype=torch.bfloat16, device=dev))
    wdeq = packed[:, :V].to(torch.bfloat16)
    cases = []
    for m in sizes:
        x = torch.randn(m, K, generator=g).to(dev, torch.bfloat16)
        got = dm.int8_matmul(x, packed, scale, None, **kw)
        want = dm.int8_matmul_plain(x, packed, scale, None, **kw)
        torch.cuda.synchronize()
        err = bf16_check(got, want, f"K2 {tag}head M={m}")
        ms = cuda_ms(lambda i: dm.int8_matmul(x, packed, scale, None, **kw),
                     1)
        plain_ms = cuda_ms(lambda i: dm.int8_matmul_plain(
            x, packed, scale, None, **kw), 1, iters=5, warmup=1, graph=False)
        xp = dm._prologue_plain(x, "layernorm", kw["ln_scale"],
                                kw["ln_bias"], 1e-5, K)
        lib_ms = cuda_ms(lambda i: torch.matmul(xp, wdeq), 1)
        # The function's bytes: the head's V columns and scales, not the
        # packed padding past out_n.
        nbytes = x.numel() * 2 + K * V + V * 4 + m * V * 2 + 2 * K * 2
        b_ms, b_by = bound(nbytes, 2.0 * m * K * V)
        log(f"K2 {tag}head M={m} K={K} N={V}: err {err:.3g} | kernel "
            f"{ms:.4f} ms plain {plain_ms:.3f} ms matmul {lib_ms:.4f} ms "
            f"bound {b_ms:.4f} ms ({b_by})")
        cases.append(dict(case=f"{tag}head M={m}", max_abs_err=err, ms=ms,
                          plain_ms=plain_ms, library_ms=lib_ms,
                          bound_ms=b_ms, bound_by=b_by, bytes=nbytes))
    return cases


def check_k3(dev, g, cfg, tp=1):
    """K3 at serving decode (OPT-1.3B: B 8, H = KV 32, D 64, S 512, 24
    layers of int8 cache with bf16 scales), scalar and ragged positions:
    pos 256 (one split of the fused kernel's rows) and 280 (two, as in the
    decode steps' positions 272-287). With ``tp``, at one rank's heads
    (H = KV 32 / tp) and the two-rank phase's batch, B 4."""
    L, B, H, S, D = cfg.n_layers, 8, cfg.n_heads, 512, cfg.head_dim
    tag = ""
    if tp > 1:
        B, H, tag = TP_BATCH, H // tp, f"tp{tp} "
    kq, ks = attn._quant_rows(torch.randn(L, B, H, S, D, device=dev))
    vq, vs = attn._quant_rows(torch.randn(L, B, H, S, D, device=dev))
    ks, vs = ks[..., 0].bfloat16(), vs[..., 0].bfloat16()
    q = torch.randn(B, H, D, generator=g).to(dev, torch.bfloat16)
    kn = torch.randn(B, H, D, generator=g).to(dev, torch.bfloat16)
    vn = torch.randn(B, H, D, generator=g).to(dev, torch.bfloat16)
    scale = 1.0 / math.sqrt(D)
    cases = []
    ragged = torch.tensor([17, 100, 200, 256, 300, 400, 511, 60][:B],
                          dtype=torch.int32, device=dev)
    for label, pos in ((f"{tag}pos 256", 256), (f"{tag}pos 280", 280),
                       (f"{tag}ragged pos", ragged)):
        planes = [kq, vq, ks, vs]
        ref = [t.clone() for t in planes]
        got = attn.fused_decode_append(q, kn, vn, planes[0], planes[1], pos,
                                       L - 1, scale, k_scale=planes[2],
                                       v_scale=planes[3])
        want = attn.fused_decode_append_plain(q, kn, vn, ref[0], ref[1], pos,
                                              L - 1, scale, k_scale=ref[2],
                                              v_scale=ref[3])
        torch.cuda.synchronize()
        err = bf16_check(got[0], want[0], f"K3 {label}")
        for a, b in zip(got[1:], want[1:]):
            if not torch.equal(a, b):
                raise AssertionError(f"K3 {label}: written cache differs")
        ms = cuda_ms(lambda i: attn.fused_decode_append(
            q, kn, vn, kq, vq, pos, i, scale, k_scale=ks, v_scale=vs), L)
        plain_ms = cuda_ms(lambda i: attn.fused_decode_append_plain(
            q, kn, vn, ref[0], ref[1], pos, i, scale, k_scale=ref[2],
            v_scale=ref[3]), L, iters=5, warmup=1, graph=False)
        p = torch.clamp(torch.as_tensor(pos, device=dev).expand(B), 0, S - 1)
        rows = int((p + 1).sum().item()) * H     # (p+1) rows per (b, head)
        nbytes = (rows * (2 * D + 2 * 2) + 3 * B * H * D * 2 + B * H * D * 2)
        b_ms, b_by = bound(nbytes, 4.0 * rows * D)
        lib_ms = None
        if label.endswith("pos 256"):
            n_lay = min(4, L)
            kd = [(kq[i, :, :, :257].float()
                   * ks[i, :, :, :257, None].float()).bfloat16()
                  for i in range(n_lay)]
            vd = [(vq[i, :, :, :257].float()
                   * vs[i, :, :, :257, None].float()).bfloat16()
                  for i in range(n_lay)]
            lib_ms = cuda_ms(lambda i: F.scaled_dot_product_attention(
                q[:, :, None], kd[i], vd[i]), n_lay)
        cases.append(dict(case=label, max_abs_err=err, ms=ms,
                          plain_ms=plain_ms, library_ms=lib_ms,
                          bound_ms=b_ms, bound_by=b_by, bytes=nbytes))
        sdpa = "n/a" if lib_ms is None else f"{lib_ms:.4f} ms"
        log(f"K3 {label}: err {err:.3g}, cache rows and scales equal | kernel "
            f"{ms:.4f} ms plain {plain_ms:.3f} ms sdpa {sdpa} bound "
            f"{b_ms:.4f} ms ({b_by})")
    return cases


def k4_sdpa(q, k, v, scale, slopes):
    """One SDPA call that computes K4's function on the same inputs, as
    ``fn(i)`` for ``cuda_ms``: causal, ``enable_gqa`` for GQA, or for ALiBi
    the bias with the causal mask as an ``attn_mask`` in q's dtype. A
    yardstick; the port never calls it."""
    T, H, KV = q.shape[1], q.shape[2], k.shape[1]
    qh = q.transpose(1, 2)
    kw = dict(scale=scale)
    if slopes is None:
        kw.update(is_causal=True, enable_gqa=KV != H)
    else:
        pos = torch.arange(T, device=q.device)
        dist = (pos[None, :] - pos[:, None]).float()
        kw["attn_mask"] = torch.where(
            dist <= 0, slopes[:, None, None] * dist, -math.inf
        ).to(q.dtype)[None]
    return lambda i: F.scaled_dot_product_attention(qh, k, v, **kw)


def check_k4(dev):
    """K4 in its three cases (``prefill_bench.K4_CASES``): the main path's
    256-bucket group (OPT-1.3B: B 4, T 256, H = KV 32, D 64), BLOOM-560m
    with ALiBi (B 4, T 256, H 16, D 64) and llama3-8b's GQA (B 1, T 1024,
    H 32, KV 8, D 128). Yardstick: SDPA (causal; for GQA with
    ``enable_gqa``; for ALiBi with the bias, causal mask included, as a
    bf16 ``attn_mask``)."""
    cases = []
    for model, B, T in prefill_bench.K4_CASES:
        q, k, v, scale, slopes = prefill_bench.k4_inputs(model, B, T, dev)
        H, KV, D = q.shape[2], k.shape[1], q.shape[3]
        label = f"{model} B={B} T={T}"
        got = attn.flash_prefill(q, k, v, scale, slopes)
        want = attn.flash_prefill_plain(q, k, v, scale, slopes)
        torch.cuda.synchronize()
        err = bf16_check(got, want, f"K4 {label}")
        ms = cuda_ms(lambda i: attn.flash_prefill(q, k, v, scale, slopes), 1)
        plain_ms = cuda_ms(lambda i: attn.flash_prefill_plain(
            q, k, v, scale, slopes), 1, iters=5, warmup=1, graph=False)
        lib_ms = cuda_ms(k4_sdpa(q, k, v, scale, slopes), 1)
        nbytes = (2 * B * T * H * D * 2 + 2 * B * T * KV * D * 2
                  + (H * 4 if slopes is not None else 0))
        b_ms, b_by = bound(nbytes, 4.0 * B * H * D * T * (T + 1) / 2)
        log(f"K4 {label} H={H} KV={KV} D={D}: err {err:.3g} | kernel "
            f"{ms:.4f} ms plain {plain_ms:.3f} ms sdpa {lib_ms:.4f} ms bound "
            f"{b_ms:.4f} ms ({b_by})")
        cases.append(dict(case=label, max_abs_err=err, ms=ms,
                          plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                          bound_by=b_by, bytes=nbytes))
    return cases + check_k4_f32(dev)


# K4's f32 route (``prefill_tf32_kernel``): TF32 products a k8 step, 3 for
# q·Kᵀ (q_lo k_hi, q_hi k_lo, q_hi k_hi) and 4 for P·V (p_lo v_hi, p_hi
# v_lo, p_hi v_mid, p_hi v_hi), over the two halves of the operations.
K4_F32_PRODUCTS = (3 + 4) / 2


def check_k4_f32(dev):
    """K4's f32 route (``prefill_tf32_kernel``: split-TF32 ``mma.sync`` on
    the tensor cores) in the three cases of ``prefill_bench.K4_CASES`` with
    f32 inputs drawn in f32: OPT-1.3B's 256-bucket shape, BLOOM-560m with
    ALiBi and llama3-8b's GQA at T 1024, each within 1e-5 of the largest
    |output| of its plain version, timed against it and against SDPA in
    f32 (causal; ``enable_gqa`` for GQA; the ALiBi bias with the causal
    mask as an f32 ``attn_mask``), beside both bounds (``f32_bound``: the
    CUDA cores' f32 rate, or the split's K4_F32_PRODUCTS TF32 products)."""
    cases = []
    for model, B, T in prefill_bench.K4_CASES:
        q, k, v, scale, slopes = prefill_bench.k4_inputs(
            model, B, T, dev, dtype=torch.float32)
        H, KV, D = q.shape[2], k.shape[1], q.shape[3]
        label = f"{model} f32 B={B} T={T}"
        got = attn.flash_prefill(q, k, v, scale, slopes)
        want = attn.flash_prefill_plain(q, k, v, scale, slopes)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        top = want.abs().max().item()
        if not torch.isfinite(got).all() or not err <= 1e-5 * top:
            raise AssertionError(f"K4 {label}: max |err| {err:.3g} over 1e-5 "
                                 f"of the largest output {top:.3g}")
        ms = cuda_ms(lambda i: attn.flash_prefill(q, k, v, scale, slopes), 1)
        plain_ms = cuda_ms(lambda i: attn.flash_prefill_plain(
            q, k, v, scale, slopes), 1, iters=5, warmup=1, graph=False)
        lib_ms = cuda_ms(k4_sdpa(q, k, v, scale, slopes), 1)
        nbytes = (2 * B * T * H * D * 4 + 2 * B * T * KV * D * 4
                  + (H * 4 if slopes is not None else 0))
        flops = 4.0 * B * H * D * T * (T + 1) / 2
        b_ms, b_by, t_f32, t_tf32 = f32_bound(nbytes, flops, K4_F32_PRODUCTS)
        log(f"K4 {label} H={H} KV={KV} D={D}: err {err:.3g} ({err / top:.3g} "
            f"of max) | kernel {ms:.4f} ms plain {plain_ms:.3f} ms sdpa f32 "
            f"{lib_ms:.4f} ms bound {b_ms:.4f} ms ({b_by}; bytes "
            f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f}, ops f32 {t_f32:.4f}, "
            f"split TF32 {t_tf32:.4f})")
        cases.append(dict(case=label, max_abs_err=err, ms=ms,
                          plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                          bound_by=b_by, bound_f32_ms=t_f32,
                          bound_tf32_ms=t_tf32, bytes=nbytes))
    return cases


def check_k4_f32_large_logits(dev):
    """K4's f32 route at large logits (``prefill_bench.K4_LARGE_CASES``: q
    and k of mean 1 and 3, ALiBi at T 1024, G 4, D 64, 80 and 128): its
    distances over the elementwise 1e-5 gate's allowance from its plain
    version and from the exact answer (f64). Where the plain version is
    within the gate of the exact answer (mean 1), the kernel must be
    within it too; where it is not (mean 3), the kernel must lie at most
    1.5x the plain version's own distance from the exact answer, as
    tests/test_torch_cuda.py test_k4_f32_large_logits_vs_exact holds it.
    (test_k4_matches_plain holds the kernel to the plain version at mean 1
    on its own inputs; here that distance is mostly the plain version's
    own, and is printed.)"""
    out = {}
    for r in prefill_bench.k4_large_logits(dev):
        label = f"D={r['D']} mean={r['mean']:g}"
        if r["plain_exact"] <= 1.0:
            ok = r["kernel_exact"] <= 1.0
        else:
            ok = r["kernel_exact"] <= 1.5 * r["plain_exact"]
        if not ok:
            raise AssertionError(f"K4 f32 large logits {label}: {r}")
        out[label] = {key: r[key] for key in
                      ("kernel_plain", "kernel_exact", "plain_exact")}
    return out


# Page geometry of the paged phases: OPT-1.3B serving pages of 64 rows, 8
# logical pages (512 rows) per sequence.
PS, MAXP = 64, 8


def strided_table(B: int, dev) -> torch.Tensor:
    """Row b's logical page j in physical page 1 + (MAXP-1-j)*B + b:
    distinct pages, strided across rows and in reverse order; page 0 is
    the trash page and stays unused."""
    j = torch.arange(MAXP)[None, :]
    b = torch.arange(B)[:, None]
    return (1 + (MAXP - 1 - j) * B + b).to(torch.int32).to(dev)


def to_pool(x, table):
    """A slot-cache plane (L, B, KV, S[, D]) laid out page by page into a
    pool (L, 1 + B*S/PS, KV, PS[, D]) through ``table``."""
    L, B, KV, S = x.shape[:4]
    rest = x.shape[4:]
    pages = x.reshape(L, B, KV, S // PS, PS, *rest).transpose(2, 3)
    pool = torch.zeros((L, 1 + B * S // PS, KV, PS, *rest), dtype=x.dtype,
                       device=x.device)
    pool[:, table.reshape(-1).long()] = pages.reshape(L, -1, KV, PS, *rest)
    return pool


def decode_bytes(p, H, D, fused: bool, paged: bool):
    """Bytes one decode-attention kernel must move at positions ``p`` (B,)
    over an int8 cache with bf16 scales: the cache rows it reads or writes
    ((p + 1) per batch row and head, each 2*D int8 plus two bf16 scales),
    q and the output (and the new K/V when fused), and the table entries
    of the pages those rows live in. Returns (bytes, rows)."""
    B = p.numel()
    rows = int((p + 1).sum().item()) * H
    nbytes = rows * (2 * D + 2 * 2) + (4 if fused else 2) * B * H * D * 2
    if paged:
        nbytes += int((p // PS + 1).sum().item()) * 4
    return nbytes, rows


def check_paged(dev, g, cfg):
    """The page-pool kernels K5, K14 and K15 and the split route's slot
    kernels K10, K11, K12 (mha_mode 'ew') and K13 (batch fold) at serving
    decode (OPT-1.3B: B 8, H = KV 32, D 64, 24 layers of int8 cache with
    bf16 scales, PS 64, MAXP 8, a strided out-of-order table of distinct
    pages), scalar (256 and 280, as in ``check_k3``) and ragged positions.
    The pool holds the slot cache's rows page by page, so K5 is held to K3
    on the same logical rows: output and written bytes equal. K13 computes K11's function on another grid,
    so its output equals K11's bit for bit. K12 keeps q, K, p and p @ V in
    f32 and rounds only its output, as its plain version does, so it is
    held within one bf16 step of it (``ulp_misses``); K11's output, with p
    rounded to bf16, must miss that bound, or the check would not tell
    K12's numerics from K11's."""
    L, B, H, D = cfg.n_layers, 8, cfg.n_heads, cfg.head_dim
    S = PS * MAXP
    gd = torch.Generator(device=dev).manual_seed(1)
    kq, ks = attn._quant_rows(torch.randn(L, B, H, S, D, device=dev,
                                          generator=gd))
    vq, vs = attn._quant_rows(torch.randn(L, B, H, S, D, device=dev,
                                          generator=gd))
    slot = [kq, vq, ks[..., 0].bfloat16(), vs[..., 0].bfloat16()]
    del kq, vq, ks, vs
    table = strided_table(B, dev)
    pool = [to_pool(x, table) for x in slot]
    q = torch.randn(B, H, D, generator=g).to(dev, torch.bfloat16)
    kn = torch.randn(B, H, D, generator=g).to(dev, torch.bfloat16)
    vn = torch.randn(B, H, D, generator=g).to(dev, torch.bfloat16)
    scale = 1.0 / math.sqrt(D)
    ragged = torch.tensor([17, 100, 200, 256, 300, 400, 511, 60],
                          dtype=torch.int32, device=dev)
    cases = {name: [] for name in ("K5", "K10", "K11", "K12", "K13", "K14",
                                   "K15")}

    def clone(planes):
        return [t.clone() for t in planes]

    def sdpa_ms(planes, gather):
        """SDPA over the rows s <= 256 dequantized to bf16 (4 layers)."""
        def rows(x, i):
            return (paged._gathered(x, table, i) if gather else x[i])[:, :,
                                                                     :257]
        n_lay = min(4, L)
        kd = [(rows(planes[0], i).float() * rows(planes[2], i)[..., None]
               .float()).bfloat16() for i in range(n_lay)]
        vd = [(rows(planes[1], i).float() * rows(planes[3], i)[..., None]
               .float()).bfloat16() for i in range(n_lay)]
        return cuda_ms(lambda i: F.scaled_dot_product_attention(
            q[:, :, None], kd[i], vd[i]), n_lay)

    def record(name, label, err, ms, plain_ms, lib_ms, nbytes, flops):
        b_ms, b_by = bound(nbytes, flops)
        cases[name].append(dict(case=label, max_abs_err=err, ms=ms,
                                plain_ms=plain_ms, library_ms=lib_ms,
                                bound_ms=b_ms, bound_by=b_by, bytes=nbytes))
        lib = "n/a" if lib_ms is None else f"{lib_ms:.4f} ms"
        log(f"{name} {label}: err {err:.3g} | kernel {ms:.4f} ms plain "
            f"{plain_ms:.3f} ms library {lib} bound {b_ms:.4f} ms ({b_by})")

    def equal(got, want, what):
        for a, b in zip(got, want):
            if not torch.equal(a, b):
                raise AssertionError(f"{what}: written bytes differ")

    for label, pos in (("pos 256", 256), ("pos 280", 280),
                       ("ragged pos", ragged)):
        p = torch.clamp(torch.as_tensor(pos, device=dev).expand(B), 0, S - 1)
        lib = label == "pos 256"

        # K5 against its plain version, and against K3 on the slot rows.
        got_p, ref_p, got_s = clone(pool), clone(pool), clone(slot)
        got = paged.paged_fused_decode_append(
            q, kn, vn, got_p[0], got_p[1], table, pos, L - 1, scale,
            k_scale=got_p[2], v_scale=got_p[3])
        want = paged.paged_fused_decode_append_plain(
            q, kn, vn, ref_p[0], ref_p[1], table, pos, L - 1, scale,
            k_scale=ref_p[2], v_scale=ref_p[3])
        k3 = attn.fused_decode_append(q, kn, vn, got_s[0], got_s[1], pos,
                                      L - 1, scale, k_scale=got_s[2],
                                      v_scale=got_s[3])
        torch.cuda.synchronize()
        err = bf16_check(got[0], want[0], f"K5 {label}")
        equal(got[1:], want[1:], f"K5 {label} vs plain")
        if not torch.equal(got[0], k3[0]):
            raise AssertionError(f"K5 {label}: output differs from K3's")
        equal(got[1:], [to_pool(x, table) for x in k3[1:]],
              f"K5 {label} vs K3")
        nbytes, rows = decode_bytes(p, H, D, True, True)
        record("K5", label, err, cuda_ms(
            lambda i: paged.paged_fused_decode_append(
                q, kn, vn, got_p[0], got_p[1], table, pos, i, scale,
                k_scale=got_p[2], v_scale=got_p[3]), L),
            cuda_ms(lambda i: paged.paged_fused_decode_append_plain(
                q, kn, vn, ref_p[0], ref_p[1], table, pos, i, scale,
                k_scale=ref_p[2], v_scale=ref_p[3]), L, iters=5, warmup=1,
                graph=False),
            sdpa_ms(pool, True) if lib else None, nbytes, 4.0 * rows * D)
        log(f"K5 {label}: output and written bytes equal K3's on the same "
            f"logical rows")
        del got_p, ref_p, got_s, got, want, k3

        # K15, K11, K12 and K13: flash decode over s <= pos.
        outs = {}
        for name, planes, fn, plain, extra in (
                ("K15", pool, paged.paged_flash_decode,
                 paged.paged_flash_decode_plain, (table,)),
                ("K11", slot, attn.flash_decode, attn.flash_decode_plain,
                 ()),
                ("K12", slot, lambda *a: attn.flash_decode(*a, mha_mode="ew"),
                 attn.flash_decode_ew_plain, ()),
                ("K13", slot,
                 lambda *a: attn.flash_decode(*a, batch_fold=True),
                 attn.flash_decode_plain, ())):
            def call(f, i, planes=planes, extra=extra):
                return f(q, planes[0], planes[1], *extra, pos, i, scale,
                         None, planes[2], planes[3])
            before = counts()[name]
            got = outs[name] = call(fn, L - 1)
            want = call(plain, L - 1)
            torch.cuda.synchronize()
            if counts()[name] != before + 1:
                raise AssertionError(f"{name} {label}: the kernel did not "
                                     "launch")
            err = bf16_check(got, want, f"{name} {label}")
            if name == "K12":
                miss, k11_miss = ulp_misses(got, want), ulp_misses(
                    outs["K11"], want)
                if miss or not k11_miss:
                    raise AssertionError(
                        f"K12 {label}: {miss} elements over one bf16 step "
                        f"of its plain version (K11's output: {k11_miss}, "
                        "must be > 0)")
                log(f"K12 {label}: within one bf16 step of its plain version"
                    f" (rtol 2^-7, atol 2^-14 max|ref|); K11's output misses"
                    f" that bound in {k11_miss} of {got.numel()} elements")
            if name == "K13":
                if not torch.equal(got, outs["K11"]):
                    raise AssertionError(f"K13 {label}: output differs from "
                                         "K11's")
                log(f"K13 {label}: output equals K11's bit for bit")
            nbytes, rows = decode_bytes(p, H, D, False, name == "K15")
            record(name, label, err, cuda_ms(lambda i: call(fn, i), L),
                   cuda_ms(lambda i: call(plain, i), L, iters=5, warmup=1,
                           graph=False),
                   sdpa_ms(planes, name == "K15") if lib else None, nbytes,
                   4.0 * rows * D)

        # K14 and K10: the append alone.
        for name, planes, fn, plain, extra in (
                ("K14", pool, paged.paged_kv_append,
                 paged.paged_kv_append_plain, (table,)),
                ("K10", slot, attn.kv_append, attn.kv_append_plain, ())):
            got_c, ref_c = clone(planes), clone(planes)

            def call(f, c, i, extra=extra):
                return f(kn, vn, c[0], c[1], *extra, pos, i, c[2], c[3])
            call(fn, got_c, L - 1)
            call(plain, ref_c, L - 1)
            torch.cuda.synchronize()
            equal(got_c, ref_c, f"{name} {label}")
            nbytes = (2 * B * H * D * 2 + B * H * (2 * D + 2 * 2)
                      + (B * 4 if extra else 0))
            record(name, label, 0.0, cuda_ms(lambda i: call(fn, got_c, i),
                                             L),
                   cuda_ms(lambda i: call(plain, ref_c, i), L, iters=5,
                           warmup=1, graph=False),
                   None, nbytes, 4.0 * B * H * D)
            del got_c, ref_c
    return cases


def check_k10_prefill(dev):
    """K10 over T rows (``attention.kv_prefill_write``) in
    ``prefill_bench.K10_PREFILL_CASES``, held equal to its plain version -
    the model's PyTorch quantization, the path before it - bit for bit:
    int8 rows, scales and the dequantized K/V. The kernel is timed as a
    CUDA graph over rotating copies larger than L2, the plain version
    eagerly. Then K10 at T = 1, B 1, KV 1 (the split route's append of
    one row), the launch floor a single-row append cannot beat. Returns
    K10's cases."""
    gd = torch.Generator(device=dev).manual_seed(12)
    cases = []
    for label, B, T, H, KV, D in prefill_bench.K10_PREFILL_CASES:
        nbytes = prefill_bench.kv_write_bytes(B, T, KV, D)
        n_copy = copies_for(nbytes)
        sets = prefill_bench.kv_write_inputs(B, T, H, KV, D, dev, n_copy)
        rows = [(k, v) for k, v, _ in sets]
        caches = [c for _, _, c in sets]
        ref = [t.clone() for t in caches[0]]
        got = attn.kv_prefill_write(*rows[0], *caches[0][:2], 0,
                                    *caches[0][2:])
        want = attn.kv_prefill_write_plain(*rows[0], *ref[:2], 0, *ref[2:])
        torch.cuda.synchronize()
        for a, b in zip([*got, *caches[0]], [*want, *ref]):
            if not torch.equal(a, b):
                raise AssertionError(f"K10 {label}: differs from its plain "
                                     "version")
        ms = cuda_ms(lambda i: attn.kv_prefill_write(
            *rows[i], *caches[i][:2], 0, *caches[i][2:]), n_copy)
        plain_ms = cuda_ms(lambda i: attn.kv_prefill_write_plain(
            *rows[i], *caches[i][:2], 0, *caches[i][2:]), n_copy, iters=5,
            warmup=1, graph=False)
        b_ms, b_by = bound(nbytes, 0.0)
        cases.append(dict(case=label, max_abs_err=0.0, ms=ms,
                          plain_ms=plain_ms, library_ms=None, bound_ms=b_ms,
                          bound_by=b_by, bytes=nbytes))
        log(f"K10 {label} KV={KV} D={D} (int8, bf16 scales): int8 rows, "
            f"scales and dequantized K/V equal the plain version's | kernel "
            f"{ms:.4f} ms, today's path (plain, eager) {plain_ms:.3f} ms, "
            f"{nbytes} bytes, bound {b_ms:.5f} ms ({b_by})")
        del sets, rows, caches, ref, got, want

    # The floor: one row of K and one of V.
    D = 64
    kn = torch.randn(1, 1, D, device=dev, generator=gd).bfloat16()
    vn = torch.randn(1, 1, D, device=dev, generator=gd).bfloat16()
    one = [torch.zeros(1, 1, 1, 512, D, dtype=torch.int8, device=dev)
           for _ in "kv"]
    one += [torch.zeros(1, 1, 1, 512, dtype=torch.bfloat16, device=dev)
            for _ in "kv"]
    ref = [t.clone() for t in one]
    attn.kv_append(kn, vn, one[0], one[1], 256, 0, one[2], one[3])
    attn.kv_append_plain(kn, vn, ref[0], ref[1], 256, 0, ref[2], ref[3])
    torch.cuda.synchronize()
    for a, b in zip(one, ref):
        if not torch.equal(a, b):
            raise AssertionError("K10 B=1 KV=1: differs from its plain "
                                 "version")
    ms = cuda_ms(lambda i: attn.kv_append(kn, vn, one[0], one[1], 256, 0,
                                          one[2], one[3]), 1, iters=64)
    plain_ms = cuda_ms(lambda i: attn.kv_append_plain(
        kn, vn, ref[0], ref[1], 256, 0, ref[2], ref[3]), 1, iters=5,
        warmup=1, graph=False)
    nbytes = 2 * D * 2 + 2 * (D + 2)
    b_ms, b_by = bound(nbytes, 0.0)
    cases.append(dict(case="floor B=1 KV=1 T=1", max_abs_err=0.0, ms=ms,
                      plain_ms=plain_ms, library_ms=None, bound_ms=b_ms,
                      bound_by=b_by, bytes=nbytes))
    log(f"K10 floor (B 1, KV 1, T 1, D 64: one K and one V row) equals its "
        f"plain version | kernel {ms:.4f} ms (graph replay, 64 launches), "
        f"plain {plain_ms:.3f} ms, bound {b_ms:.7f} ms ({b_by})")
    return cases


# ---- phase 3: the Engine ------------------------------------------------------


PROMPT_LENS = [12, 30, 50, 100, 140, 200, 250, 20]   # buckets 16..256
NEW_TOKENS = 32


def run_engine(dev, cfg, card: str):
    """The int4 'pair' model (K1) served as ``serve`` says, on both
    routes; ``card``: the card's name and power limit, printed beside the
    decode rate. Returns (launches, metrics, the state later phases
    reuse)."""
    t0 = time.perf_counter()
    params, _ = random_packed_params(cfg, seed=0, fuse_qkv=True,
                                     layout="pair", device=dev)
    params = pack_lm_head(cfg, params, nbits=8)
    torch.cuda.synchronize()
    log(f"random int4 pair params + int8 head: "
        f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in PROMPT_LENS]
    launches, metrics, _, engine, comps = serve(
        dev, cfg, card, "int4", params, K1, prompts, NEW_TOKENS,
        compare=True)
    state = dict(params=params, prompts=prompts, cache=engine.cache,
                 tokens=[c.tokens for c in comps])
    metrics.update(trace_engine(dev, cfg, params, prompts, card,
                                metrics["int4_engine_run_s"]))
    return launches, metrics, state


def trace_engine(dev, cfg, params, prompts, card, run_s):
    """The int4 Engine run once more on the graph route, under
    ``torch.profiler`` (trace under the git-ignored ``traces/engine``):
    the card's time in the run (every kernel, copy and set) against
    ``run_s``, the same run's wall time without the profiler (whose own
    host cost, its start above all, swamps the traced run's wall): the
    device's busy share of an Engine run. Returns metrics."""
    engine = Engine(cfg, params, max_slots=8, max_seq_len=512,
                    cache_dtype=torch.int8, device=dev, use_kernel=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with device_trace(os.path.join(ROOT, "traces", "engine")) as prof:
        engine.run([Request(prompt=p, max_new_tokens=NEW_TOKENS)
                    for p in prompts])
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    summary = trace_summary(prof, top=6)
    busy = summary["device_ms"] / (run_s * 1e3)
    if not summary["device_ms"] > 0:
        raise AssertionError("the Engine's trace holds no device time")
    log(f"int4 Engine under torch.profiler (graph route): "
        f"{summary['device_ms']:.3f} ms on the card, busy {busy:.3f} of the "
        f"unprofiled run's {run_s * 1e3:.1f} ms ({wall_ms:.1f} ms wall "
        f"under the profiler); top kernels "
        + json.dumps([[k[:60], round(ms, 3), n]
                      for k, ms, n in summary["kernels"]]) + f" ({card})")
    return dict(int4_engine_trace_wall_ms=wall_ms,
                int4_engine_trace_device_ms=summary["device_ms"],
                int4_engine_trace_busy=busy)


@contextlib.contextmanager
def timed(owner, name, seconds):
    """Every call of ``owner.name`` inside the block, timed by the host
    clock between synchronizations; their total goes to ``seconds[0]``,
    their number to ``seconds[1]``."""
    inner = getattr(owner, name)

    def wrapped(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner(*a, **kw)
        torch.cuda.synchronize()
        seconds[0] += time.perf_counter() - t0
        seconds[1] += 1
        return out
    setattr(owner, name, wrapped)
    try:
        yield
    finally:
        setattr(owner, name, inner)


def engine_run(engine, reqs, what, card):
    """Serve ``reqs`` through ``engine`` from zeroed launch counts, with
    the time its prefills take and its decode calls (``Engine._decode``:
    the buffers' copies in, the steps, the tokens' copy out). Returns
    (completions, the run's launches, metrics: wall, prefill, decode
    (the wall less the prefills) and decode-call seconds, the end-to-end
    and the decode tokens/s)."""
    kernels.reset_launch_counts()
    prefill_s, decode_s = [0.0, 0], [0.0, 0]
    t0 = time.perf_counter()
    with timed(engine_mod, "prefill", prefill_s), \
            timed(engine, "_decode", decode_s):
        comps = engine.run(reqs)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = {k: n for k, n in counts().items() if n}
    new = sum(len(c.new_tokens) for c in comps)
    rest_s = run_s - prefill_s[0]
    # The first token of a request comes from its prefill.
    m = dict(run_s=run_s, prefill_s=prefill_s[0], prefills=prefill_s[1],
             decode_s=rest_s, decode_calls_s=decode_s[0],
             decode_calls=decode_s[1], tokens_per_s=new / run_s,
             decode_tokens_per_s=(new - len(comps)) / rest_s,
             capture_s=sum(r.capture_s for r in engine.runners.values()))
    route = "graph" if engine.graphs else "eager"
    log(f"{what} Engine ({route} route): {len(reqs)} requests, {new} new "
        f"tokens in {run_s:.3f} s ({m['tokens_per_s']:.1f} tokens/s), of "
        f"which its {prefill_s[1]} prefills {prefill_s[0]:.3f} s and the "
        f"rest {rest_s:.3f} s ({m['decode_tokens_per_s']:.1f} decode "
        f"tokens/s): {decode_s[1]} decode calls {decode_s[0]:.3f} s (the "
        f"graphs' first steps and captures {m['capture_s']:.3f} s); "
        f"launches {launches} ({card})")
    return comps, launches, m


def check_replays(engine, launches, per_step, per_prefill, prefills, what):
    """The run's launches through the replay accounting: each of the
    Engine's decode-step runners captured ``per_step`` (one step's
    launches, by kernel name), and the run launched ``per_prefill`` a
    prefill and ``per_step`` a decode step (each runner's eager steps
    before its captures, and its replays), K4 aside (its launches follow
    the prompts). Returns the decode steps."""
    steps = 0
    for mode, run in engine.runners.items():
        got = {k.name: n for k, n in run.captured.items()}
        if got != per_step or run.replays <= 0:
            raise AssertionError(f"{what}: the {mode} runner captured "
                                 f"{got}, replayed {run.replays} times")
        steps += run.captures + run.replays
    want = {k: per_prefill.get(k, 0) * prefills + per_step.get(k, 0) * steps
            for k in set(per_step) | set(per_prefill)}
    got = {k: n for k, n in launches.items() if k != "K4"}
    if got != want:
        raise AssertionError(f"{what}: {prefills} prefills and {steps} "
                             f"decode steps launched {got}, not {want}")
    log(f"{what}: {steps} decode steps, each replay counting the captured "
        f"step's {per_step}; the run's launches {got} equal {prefills} "
        f"prefills' and {steps} steps'")
    return steps


def same_tokens(comps, want, what):
    """Raises unless every completion's tokens equal ``want``'s."""
    for c, w in zip(comps, want):
        if not np.array_equal(c.tokens, w):
            raise AssertionError(f"{what}: request {c.request_id}'s tokens "
                                 f"differ")
    log(f"{what}: every request's tokens equal, bit for bit")


def serve(dev, cfg, card, what, params, kernel, prompts, n_new, hold=True,
          compare=False):
    """Serve the prompts (greedy, ``n_new`` tokens each) through the slot
    Engine on ``params``, whose linears all run ``kernel``, on the graph
    route (each decode step a CUDA graph replay), with the time its
    prefills take; check the launches of the run through the replay
    accounting (4 a layer of ``kernel``: qkv, o, fc1, fc2, and one K2 a
    prefill and a step; one K3 a layer a step; one K10 a layer a prefill)
    and of one decode step through the public entry point, the prefill
    logits (kernels vs plain versions; ``hold``: see check_prefill) and
    each layer; with ``compare``, serve them again on the eager route
    (``graphs=False``): the same tokens, bit for bit. Time a full-depth
    prefill of the 256-bucket group (4 rows x 256, eager between CUDA
    events) and batch-8 decode. Returns (the run's launches, metrics, the
    kernels' full-depth prefill logits, the Engine, its completions)."""
    engine = Engine(cfg, params, max_slots=8, max_seq_len=512,
                    cache_dtype=torch.int8, device=dev, use_kernel=True)
    reqs = [Request(prompt=p, max_new_tokens=n_new) for p in prompts]
    comps, launches, run_m = engine_run(engine, reqs, what, card)
    if not engine.graphs or set(engine.runners) != {"greedy"}:
        raise AssertionError(f"{what}: the Engine ran on the eager route")
    L = cfg.n_layers
    if set(launches) != {kernel.name, "K2", "K3", "K4", "K10"}:
        raise AssertionError(f"{what}: the Engine launched {launches}")
    steps = check_replays(
        engine, launches, {kernel.name: 4 * L, "K2": 1, "K3": L},
        {kernel.name: 4 * L, "K2": 1, "K10": L}, run_m["prefills"], what)
    check_completions(comps, prompts, cfg, f"{what} Engine", n_new)
    metrics = {f"engine_{k}": v for k, v in run_m.items()}
    metrics["engine_decode_steps"] = steps
    if compare:
        eager = Engine(cfg, params, max_slots=8, max_seq_len=512,
                       cache_dtype=torch.int8, device=dev, use_kernel=True,
                       graphs=False)
        eager_comps, _, eager_m = engine_run(
            eager, [Request(prompt=p, max_new_tokens=n_new)
                    for p in prompts], what, card)
        same_tokens(eager_comps, [c.tokens for c in comps],
                    f"{what} Engine, graph vs eager route")
        metrics.update({f"eager_engine_{k}": v for k, v in eager_m.items()})
        del eager
    dec_rel, dec_agree = check_decode(
        cfg, params, engine.cache, last_tokens(comps, dev),
        max(len(c.tokens) for c in comps), f"{what} ", hold)

    kernels.reset_launch_counts()
    tok = torch.zeros((8, 1), dtype=torch.int64, device=dev)
    logits, _ = decode_step(cfg, params, tok, engine.cache, 300,
                            use_kernel=True)
    torch.cuda.synchronize()
    step = {k: n for k, n in counts().items() if n}
    if step != {kernel.name: 4 * cfg.n_layers, "K2": 1, "K3": cfg.n_layers}:
        raise AssertionError(f"{what}: one decode step launched {step}")
    if logits.shape != (8, cfg.vocab_size) or not torch.isfinite(logits).all():
        raise AssertionError(f"{what}: decode logits not finite (8, vocab)")
    log(f"{what}: one decode step launches {step}")

    toks = group_tokens(prompts, dev)
    err1, rel, agree, full = check_prefill(dev, cfg, params, toks,
                                           f"{what} ", hold)
    layers_err = check_layers(dev, cfg, params, toks, f"{what} ")
    prefill_ms = prefill_bench.time_prefill(cfg, params, toks[0], reps=3)
    log(f"{what} prefill of the 256-bucket group (4 x 256, {cfg.n_layers} "
        f"layers, eager): {prefill_ms:.3f} ms ({card})")
    ms_step, loop_ms, dev_ms = time_decode(dev, cfg, params, engine.cache,
                                           card, f"{what} decode")
    metrics.update({"prefill_ms": prefill_ms, "decode_ms_per_step": ms_step,
                    "decode_tokens_per_s": 8e3 / ms_step,
                    "decode_loop_graph_ms_per_step": loop_ms,
                    "decode_loop_graph_tokens_per_s": 8e3 / loop_ms,
                    "decode_step_graph_ms": dev_ms,
                    "prefill_layer1_max_err": err1,
                    "prefill_full_rel_l2": rel,
                    "prefill_full_argmax_agree": agree,
                    "decode_full_rel_l2": dec_rel,
                    "decode_full_argmax_agree": dec_agree,
                    "layers_max_err": layers_err})
    return (launches, {f"{what}_{k}": v for k, v in metrics.items()}, full,
            engine, comps)


def group_tokens(prompts, dev):
    """The 256-bucket admission group: (its 3 prompts in 4 rows, 3)."""
    group = [p for p in prompts if 128 < len(p) <= 256]
    toks = np.zeros((4, 256), np.int32)
    for r, p in enumerate(group):
        toks[r, :len(p)] = p
    return torch.as_tensor(toks, dtype=torch.int64, device=dev), len(group)


def prefill_logits(dev, cfg, params, toks, n_layers, use_kernel,
                   cache_dtype=torch.int8):
    """Logits of the group's prompts (``toks``: group_tokens' pair)."""
    rows, n = toks
    c = dataclasses.replace(cfg, n_layers=n_layers)
    cache = init_kv_cache(c, rows.shape[0], 256, cache_dtype, device=dev)
    logits, _ = prefill(c, dict(params, layers=params["layers"][:n_layers]),
                        rows, cache, use_kernel=use_kernel)
    return logits[:n].float()


def rel_l2(got, want, what, hold=True):
    """Relative L2 of ``got`` against ``want`` and their argmax agreement;
    raises if ``got`` is not finite or, when ``hold``, the L2 is over
    2^-6."""
    rel = ((got - want).norm() / want.norm()).item()
    if not torch.isfinite(got).all() or (hold and not rel <= 2 ** -6):
        raise AssertionError(f"{what}: relative L2 {rel:.4g} over 2^-6")
    return rel, (got.argmax(-1) == want.argmax(-1)).float().mean().item()


def check_layers(dev, cfg, params, toks, what):
    """Every layer at full depth, the kernels against their plain versions
    on the same input (the kernel path's hidden state, so no difference
    carries from one layer to the next): within the bf16 tolerance.
    Returns the largest max |err|."""
    rows, n = toks
    positions = torch.arange(rows.shape[1], device=dev).expand(*rows.shape)
    slopes = tr._slopes(cfg, dev)
    x = tr._embed(cfg, params, rows, positions, True)
    worst = 0.0
    for i, layer in enumerate(params["layers"]):
        got = tr._block(cfg, layer, x, positions, None, slopes, True)
        want = tr._block(cfg, layer, x, positions, None, slopes, False)
        worst = max(worst, bf16_check(got[:n], want[:n],
                                      f"{what}layer {i}, kernels vs plain"))
        x = got
    log(f"{what}each of {cfg.n_layers} layers on the kernel path's input, "
        f"kernels vs plain versions: max |err| {worst:.4g} (bf16 tolerance)")
    return worst


def check_prefill(dev, cfg, params, toks, what, hold=True):
    """The group prefilled through the prefill entry point with the kernels
    and with their plain versions on the card (use_kernel=False). Through
    the first layer and the head, the logits agree within the bf16
    tolerance. Through all layers they cannot: the two sum in different
    orders, each op's outputs then differ by one bf16 step in about 1e-4
    to 1e-3 of their elements, and the next wide product spreads that to
    most elements, layer after layer (42% of the logits differ after one
    layer, 86% after 24, relative L2 3e-3 -> 1.25e-2, H100 700 W, this
    script's data). Full depth is held to a relative L2 of at most 2^-6,
    or only measured without ``hold``. Returns (layer-1 max error,
    full-depth relative L2, argmax agreement, the kernels' full-depth
    logits)."""
    err1 = bf16_check(prefill_logits(dev, cfg, params, toks, 1, True),
                      prefill_logits(dev, cfg, params, toks, 1, False),
                      f"{what}prefill logits through layer 1, kernels vs "
                      "plain")
    got = prefill_logits(dev, cfg, params, toks, cfg.n_layers, True)
    want = prefill_logits(dev, cfg, params, toks, cfg.n_layers, False)
    rel, agree = rel_l2(got, want, f"{what}prefill logits through "
                        f"{cfg.n_layers} layers", hold)
    log(f"{what}prefill logits (3 prompts, bucket 256), kernels vs plain "
        f"versions: layer 1 max |err| {err1:.4g} (bf16 tolerance); "
        f"{cfg.n_layers} layers relative L2 {rel:.4g} "
        f"({'<= 2^-6' if hold else 'measured, not held'}), max |err| "
        f"{(got - want).abs().max().item():.4g}, argmax agreement {agree:.4f}")
    return err1, rel, agree, got


def check_decode(cfg, params, cache, tok, pos, what, hold=True):
    """One decode step of ``tok`` at ``pos`` from two clones of ``cache``
    (a slot cache or a page pool), through the public entry point with the
    kernels and with their plain versions on the card (use_kernel=False):
    the full-depth logits held to a relative L2 of at most 2^-6 (or only
    measured without ``hold``), as check_prefill holds the prefill's, and
    their argmax agreement measured. The per-projection checks hold each
    kernel alone; this holds the decode route through the whole model.
    Returns (relative L2, argmax agreement)."""
    def clone():
        return {k: v.clone() for k, v in cache.items()}
    got, _ = decode_step(cfg, params, tok, clone(), pos, use_kernel=True)
    want, _ = decode_step(cfg, params, tok, clone(), pos, use_kernel=False)
    got, want = got.float(), want.float()
    rel, agree = rel_l2(got, want, f"{what}decode logits through "
                        f"{cfg.n_layers} layers", hold)
    log(f"{what}decode logits (batch 8, one step at position {pos}), "
        f"kernels vs plain versions: {cfg.n_layers} layers relative L2 "
        f"{rel:.4g} ({'<= 2^-6' if hold else 'measured, not held'}), max "
        f"|err| {(got - want).abs().max().item():.4g}, argmax agreement "
        f"{agree:.4f}")
    return rel, agree


def last_tokens(comps, dev):
    """Each completion's last token, as the next decode step's input."""
    return torch.as_tensor([[int(c.tokens[-1])] for c in comps],
                           dtype=torch.int64, device=dev)


def time_decode(dev, cfg, params, cache, card, what):
    """Batch-8 greedy decode over ``cache`` (a slot cache or a pool) from
    ctx 256, 32 steps of the decode loop's runner (``DecodeGraph``, the
    Engine's) on each route: eager (Python issues every launch) and as
    graph replays (after a 4-step call that captures), by the host clock
    between synchronizations; and one decode step's device time at ctx
    288 (the step captured 4 times in one CUDA graph, replayed between
    CUDA events). Returns (eager ms/step, graph loop ms/step, single-step
    graph ms)."""
    steps, ms = 32, {}
    for graphs in (False, True):
        run = DecodeGraph(cfg, params, 8, steps, device=dev, graphs=graphs)
        run.pos.fill_(256)
        run.run(cache, 4)
        run.pos.fill_(256)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run.run(cache, steps)
        torch.cuda.synchronize()
        ms[graphs] = (time.perf_counter() - t0) / steps * 1e3
    tok = torch.zeros((8, 1), dtype=torch.int64, device=dev)
    dev_ms = cuda_ms(lambda i: decode_step(cfg, params, tok, cache, 288,
                                           use_kernel=True), 1, iters=4)
    log(f"{what}: batch 8, ctx 256-{256 + steps}, {steps} steps: eager "
        f"{ms[False]:.3f} ms/step ({8e3 / ms[False]:.1f} tokens/s), graph "
        f"loop {ms[True]:.3f} ms/step ({8e3 / ms[True]:.1f} tokens/s, "
        f"{ms[True] / dev_ms:.3f}x the single step); one step replayed as "
        f"a CUDA graph: {dev_ms:.3f} ms ({card})")
    return ms[False], ms[True], dev_ms


def counts():
    return {k.name: k.launches for k in kernels.KERNELS}


def check_completions(comps, prompts, cfg, what, n_new=NEW_TOKENS):
    for c, p in zip(comps, prompts):
        if (len(c.new_tokens) != n_new or c.finish_reason != "length"
                or not ((c.new_tokens >= 0)
                        & (c.new_tokens < cfg.vocab_size)).all()
                or not np.array_equal(c.tokens[:len(p)], p)):
            raise AssertionError(f"{what}: bad completion {c.request_id}")


def serve_paged(engine, reqs):
    """Submit ``reqs``, take the first step (admission, one decode step)
    and a second, pure decode step, then step until drained. Returns
    (completions in submission order, the second step's launches, the
    queue left after the first step)."""
    ids = [engine.submit(r) for r in reqs]
    engine.step()
    queued = len(engine.queue)
    before = counts()
    engine.step()
    torch.cuda.synchronize()
    step = {k: n - before[k] for k, n in counts().items()}
    while engine.has_work():
        engine.step_auto()
    by_id = {c.request_id: c for c in engine.finished}
    return [by_id[i] for i in ids], step, queued


def run_paged_engine(dev, cfg, card: str, state):
    """The paged Engine (page pool of 64-row pages) on the slot phase's
    params and requests, on the graph route. Run A, default pool: all 8
    requests admitted at once, the slot Engine's tokens, 96 K1 + 1 K2 + 24
    K5 (no K3) per decode step, counted at its replay; run A again on the
    eager route: the same tokens. Run B, 17 pages (16 usable of the 20 the
    requests need): admission blocks, pages are recycled. Then decode
    through a pool that holds the slot cache's rows: the slot cache's
    logits bit for bit, and its rate. Returns (run A's launches, metrics,
    that pool)."""
    params, prompts = state["params"], state["prompts"]

    def engine(**kw):
        return Engine(cfg, params, max_slots=8, max_seq_len=512,
                      cache_dtype=torch.int8, paged=True, page_size=PS,
                      device=dev, use_kernel=True, **kw)

    def requests():
        return [Request(prompt=p, max_new_tokens=NEW_TOKENS) for p in prompts]

    eng = engine()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    comps, step, queued = serve_paged(eng, requests())
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = counts()
    if not eng.graphs or eng.runners["greedy"].replays <= 0:
        raise AssertionError("paged run A: not on the graph route")
    log(f"paged Engine run A ({eng.total_pages} pages of {PS}): 8 requests "
        f"x {NEW_TOKENS} tokens in {run_s:.2f} s; launches "
        f"{ {k: n for k, n in launches.items() if n} }")
    if queued:
        raise AssertionError("run A: the default pool did not admit all 8")
    if {k for k, n in launches.items() if n} != {"K1", "K2", "K4", "K5",
                                                  "K10"}:
        raise AssertionError(f"the paged path launched {launches}")
    want = {"K1": 4 * cfg.n_layers, "K2": 1, "K5": cfg.n_layers}
    if {k: n for k, n in step.items() if n} != want:
        raise AssertionError(f"one paged decode step launched {step}")
    log(f"one paged decode step launches {want}, no K3")
    check_completions(comps, prompts, cfg, "paged run A")
    for c, tokens in zip(comps, state["tokens"]):
        if not np.array_equal(c.tokens, tokens):
            raise AssertionError(f"paged run A: request {c.request_id}'s "
                                 f"tokens differ from the slot Engine's")
    log("paged run A: greedy tokens equal the slot Engine's")
    eager = engine(graphs=False)
    t0 = time.perf_counter()
    eager_comps, eager_step, _ = serve_paged(eager, requests())
    torch.cuda.synchronize()
    eager_s = time.perf_counter() - t0
    same_tokens(eager_comps, [c.tokens for c in comps],
                "paged run A, graph vs eager route")
    if eager_step != step:
        raise AssertionError(f"paged run A: an eager decode step launched "
                             f"{eager_step}, a replayed one {step}")
    log(f"paged run A: graph route {run_s:.3f} s, eager route "
        f"{eager_s:.3f} s ({card})")
    del eager
    if (sorted(eng._free_pages) != list(range(1, eng.total_pages))
            or eng._slot_pages):
        raise AssertionError("paged run A: pages not returned")

    eng_b = engine(total_pages=17)
    kernels.reset_launch_counts()
    comps_b, _, queued = serve_paged(eng_b, requests())
    torch.cuda.synchronize()
    check_completions(comps_b, prompts, cfg, "paged run B")
    if not queued or K5.launches <= 0:
        raise AssertionError(f"paged run B: {queued} requests queued after "
                             f"the first admission, {K5.launches} K5")
    if (sorted(eng_b._free_pages) != list(range(1, 17))
            or eng_b._slot_pages):
        raise AssertionError("paged run B: pages not returned")
    agree_b = float(np.mean([np.mean(a.new_tokens == b.new_tokens)
                             for a, b in zip(comps_b, comps)]))
    log(f"paged run B (17 pages): {queued} of 8 requests waited for pages; "
        f"all pages returned; new-token agreement with run A {agree_b:.4f} "
        f"(prefill groups differ)")

    # Decode through a pool holding the slot cache's rows, strided and out
    # of order: the slot cache's logits bit for bit, then the rate.
    table = strided_table(8, dev)
    pool = {k: to_pool(v, table) for k, v in state["cache"].items()}
    pool["page_table"] = table
    tok = torch.zeros((8, 1), dtype=torch.int64, device=dev)
    slot_cache = {k: v.clone() for k, v in state["cache"].items()}
    want, _ = decode_step(cfg, params, tok, slot_cache, 256, use_kernel=True)
    got, _ = decode_step(cfg, params, tok, pool, 256, use_kernel=True)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError("decode through the pool: logits differ from "
                             "the slot cache's")
    del slot_cache
    rel, agree = check_decode(cfg, params, pool, tok, 257, "paged ")
    log("paged decode: logits at ctx 256 equal the slot cache's")
    ms_step, loop_ms, dev_ms = time_decode(dev, cfg, params, pool, card,
                                           "paged decode")
    return launches, dict(paged_run_s=run_s, paged_eager_run_s=eager_s,
                          paged_pages=eng.total_pages,
                          paged_decode_full_rel_l2=rel,
                          paged_decode_full_argmax_agree=agree,
                          paged_small_pool_agree=agree_b,
                          paged_decode_ms_per_step=ms_step,
                          paged_decode_tokens_per_s=8e3 / ms_step,
                          paged_decode_loop_graph_ms_per_step=loop_ms,
                          paged_decode_step_graph_ms=dev_ms), pool


@contextlib.contextmanager
def split_route(**knobs):
    """The split route (FLASH_FUSED_APPEND off) with the ``ops/attention``
    knobs ``knobs`` set; every knob is restored at exit."""
    knobs = dict(FLASH_FUSED_APPEND=False, **knobs)
    old = {k: getattr(attn, k) for k in knobs}
    for k, v in knobs.items():
        setattr(attn, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(attn, k, v)


# The split routes: (label, cache, knobs, the append and decode kernels).
# The page pool has no 'ew' or batch-folded schedule.
SPLIT_ROUTES = (
    ("slot", "slot", {}, ("K10", "K11")),
    ("slot ew", "slot", {"FLASH_MHA_MODE": "ew"}, ("K10", "K12")),
    ("slot bfold", "slot", {"FLASH_BATCH_FOLD": True}, ("K10", "K13")),
    ("slot ew+bfold", "slot", {"FLASH_MHA_MODE": "ew",
                               "FLASH_BATCH_FOLD": True}, ("K10", "K12")),
    ("paged", "pool", {}, ("K14", "K15")))


def run_split(dev, cfg, state, pool):
    """One decode step on each split route (FLASH_FUSED_APPEND off) over
    the slot cache and over the pool, each after the fused route's step at
    the same position (every row active): 24 K10 + 24 K11, 24 K10 + 24 K12
    ('ew'), 24 K10 + 24 K13 (batch fold), 'ew' again with both knobs set
    ('ew' wins), then 24 K14 + 24 K15. Through the first layer the logits
    agree with the fused route's within the bf16 tolerance; through all
    24, within a relative L2 of 2^-6, for the reason the prefill check
    gives (the two sum the new token in another order, K12 keeps p in f32,
    and each wide product spreads one bf16 step). Then times one step on
    each route as a CUDA graph. Returns (each split kernel's launches, the
    step times)."""
    params = state["params"]
    tok = torch.zeros((8, 1), dtype=torch.int64, device=dev)
    caches = {"slot": state["cache"], "pool": pool}
    launches, metrics = {}, {}

    def both(n_layers, cache, knobs):
        c = dataclasses.replace(cfg, n_layers=n_layers)
        p = dict(params, layers=params["layers"][:n_layers])
        cache = {k: v if k == "page_table" else v[:n_layers]
                 for k, v in cache.items()}
        fused, _ = decode_step(c, p, tok, cache, 300, use_kernel=True)
        with split_route(**knobs):
            kernels.reset_launch_counts()
            split, _ = decode_step(c, p, tok, cache, 300, use_kernel=True)
            torch.cuda.synchronize()
            step = counts()
        return fused.float(), split.float(), step

    def step_ms(cache):
        return cuda_ms(lambda i: decode_step(cfg, params, tok, cache, 300,
                                             use_kernel=True), 1, iters=4)

    for mode, which, knobs, names in SPLIT_ROUTES:
        cache = caches[which]
        fused, split, _ = both(1, cache, knobs)
        err1 = bf16_check(split, fused,
                          f"split route ({mode}) logits through layer 1")
        fused, split, step = both(cfg.n_layers, cache, knobs)
        want = {"K1": 4 * cfg.n_layers, "K2": 1, names[0]: cfg.n_layers,
                names[1]: cfg.n_layers}
        if {k: n for k, n in step.items() if n} != want:
            raise AssertionError(f"split route ({mode}): one step launched "
                                 f"{step}")
        rel = ((split - fused).norm() / fused.norm()).item()
        if not rel <= 2 ** -6 or not torch.isfinite(split).all():
            raise AssertionError(f"split route ({mode}): relative L2 "
                                 f"{rel:.4g} over 2^-6")
        launches.setdefault(names[0], step[names[0]])
        launches.setdefault(names[1], step[names[1]])
        agree = (split.argmax(-1) == fused.argmax(-1)).float().mean().item()
        log(f"split route ({mode}): one decode step launches {want}; logits "
            f"vs the fused route's: layer 1 max |err| {err1:.4g} (bf16 "
            f"tolerance), {cfg.n_layers} layers relative L2 {rel:.4g} "
            f"(<= 2^-6), max |err| {(split - fused).abs().max().item():.4g}, "
            f"argmax agreement {agree:.4f}")
        # Keys: slot_/paged_{fused,split}_step_graph_ms as before the knobs,
        # then slot_ew_, slot_bfold_ and slot_ew_bfold_split_step_graph_ms.
        key = mode.replace(" ", "_").replace("+", "_")
        fused_key = f"{mode.split()[0]}_fused_step_graph_ms"
        if fused_key not in metrics:
            metrics[fused_key] = step_ms(cache)
        with split_route(**knobs):
            metrics[f"{key}_split_step_graph_ms"] = ms = step_ms(cache)
        log(f"split route ({mode}): one decode step at ctx 300 replayed as a "
            f"CUDA graph: {ms:.3f} ms, fused route "
            f"{metrics[fused_key]:.3f} ms")
    return launches, metrics


def run_ew_engine(dev, cfg, state, card):
    """The slot Engine on the 'ew' split route (K10 + K12; the graph
    captured with those knobs) serves the phase-3 prompts, 16 new tokens
    each: well formed completions, and each decode step (counted at its
    replay) and one through the public entry point launching 96 K1, 1 K2,
    24 K10 and 24 K12. Its tokens need not equal the default route's
    (K12's f32 softmax is other arithmetic); their agreement is measured.
    Returns metrics."""
    params, prompts = state["params"], state["prompts"]
    n_new = LAYOUT_NEW_TOKENS
    L = cfg.n_layers
    with split_route(FLASH_MHA_MODE="ew"):
        engine = Engine(cfg, params, max_slots=8, max_seq_len=512,
                        cache_dtype=torch.int8, device=dev, use_kernel=True)
        comps, run, run_m = engine_run(
            engine, [Request(prompt=p, max_new_tokens=n_new)
                     for p in prompts], "ew", card)
        run_s = run_m["run_s"]
        check_replays(engine, run,
                      {"K1": 4 * L, "K2": 1, "K10": L, "K12": L},
                      {"K1": 4 * L, "K2": 1, "K10": L}, run_m["prefills"],
                      "ew Engine")
        check_completions(comps, prompts, cfg, "ew Engine", n_new)
        rel, dec_agree = check_decode(
            cfg, params, engine.cache, last_tokens(comps, dev),
            max(len(c.tokens) for c in comps), "ew ")
        kernels.reset_launch_counts()
        tok = torch.zeros((8, 1), dtype=torch.int64, device=dev)
        logits, _ = decode_step(cfg, params, tok, engine.cache, 300,
                                use_kernel=True)
        torch.cuda.synchronize()
        step = {k: n for k, n in counts().items() if n}
    if set(run) != {"K1", "K2", "K4", "K10", "K12"}:
        raise AssertionError(f"ew Engine: the run launched {run}")
    want = {"K1": 4 * cfg.n_layers, "K2": 1, "K10": cfg.n_layers,
            "K12": cfg.n_layers}
    if step != want or not torch.isfinite(logits).all():
        raise AssertionError(f"ew Engine: one decode step launched {step}")
    agree = float(np.mean([
        np.mean(c.new_tokens == tokens[len(p):len(p) + n_new])
        for c, p, tokens in zip(comps, prompts, state["tokens"])]))
    log(f"ew Engine (split route, FLASH_MHA_MODE='ew'): 8 requests x {n_new} "
        f"tokens in {run_s:.2f} s; launches {run}; one decode step launches "
        f"{want}, no K3/K11; new-token agreement with the default route "
        f"{agree:.4f} (not held: K12's f32 softmax is other arithmetic)")
    return dict(ew_engine_run_s=run_s, ew_engine_token_agree=agree,
                ew_decode_full_rel_l2=rel,
                ew_decode_full_argmax_agree=dec_agree)


def run_sampled(dev, cfg, state, card):
    """The phase-3 prompts sampled (temperature 0.8, top-k 40, top-p 0.9;
    the Engine's generator from seed 1234), 16 new tokens each, through
    the slot Engine on the graph route and on the eager route: the same
    tokens, bit for bit (the generator is registered with the graph, so
    the replays draw the eager steps' numbers). Then times the top-k/p
    step's replay between CUDA events (phase 3's graph loop is the greedy
    step's). Returns metrics."""
    params, prompts = state["params"], state["prompts"]
    n_new = LAYOUT_NEW_TOKENS
    out = {}
    for graphs in (True, False):
        engine = Engine(cfg, params, max_slots=8, max_seq_len=512,
                        cache_dtype=torch.int8, seed=1234, device=dev,
                        use_kernel=True, graphs=graphs)
        comps, _, m = engine_run(
            engine, [Request(prompt=p, max_new_tokens=n_new,
                             temperature=0.8, top_k=40, top_p=0.9)
                     for p in prompts], "sampled", card)
        if set(engine.runners) != {"topkp"}:
            raise AssertionError(f"sampled Engine: runners "
                                 f"{set(engine.runners)}")
        out[graphs] = comps, m
        if graphs:
            # The drained Engine's runner, replayed over its cache: as one
            # call of max_steps steps (its step index stays in the token
            # buffer).
            run = engine.runners["topkp"]
            run._index.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(run.max_steps):
                run.graph.replay()
            end.record()
            end.synchronize()
            step_ms = start.elapsed_time(end) / run.max_steps
        del engine
    comps = out[True][0]
    check_completions(comps, prompts, cfg, "sampled Engine", n_new)
    same_tokens(out[False][0], [c.tokens for c in comps],
                "sampled Engine, graph vs eager route")
    greedy = float(np.mean([
        np.mean(c.new_tokens == tokens[len(p):len(p) + n_new])
        for c, p, tokens in zip(comps, prompts, state["tokens"])]))
    log(f"sampled Engine: new-token agreement with the greedy run "
        f"{greedy:.4f} (measured); one top-k/p step replayed: "
        f"{step_ms:.3f} ms ({card})")
    return dict(sampled_step_graph_ms=step_ms,
                sampled_engine_run_s=out[True][1]["run_s"],
                sampled_eager_engine_run_s=out[False][1]["run_s"],
                sampled_greedy_agree=greedy)


# decode_perplexity against perplexity at OPT-1.3B int4: bf16 activations
# rounded in other places on the two routes (K1's streaming kernel at M =
# 2 against its tensor-core kernel at M = 512, K3 against K4).
PPL_RTOL = 0.01


def run_perplexity(dev, cfg, state, card):
    """The int4 model of phase 3 (full width and depth) scored on a
    synthetic Zipf stream (``models/data.py``, seed 0) of 2 x 256-token
    windows: ``perplexity`` (one forward: 96 K1 and one K2 at M = 512, 24
    K4) and ``decode_perplexity`` (255 teacher-forced steps through the
    decode loop's graph, f32 cache as JAX's default: 96 K1, one K2 and 24
    K3 a step), each timed once by the host clock between
    synchronizations (the graph's capture included); their relative
    difference held to PPL_RTOL. Returns metrics."""
    params, L = state["params"], cfg.n_layers
    batches = list(chunk_tokens(synthetic_stream(cfg.vocab_size, 512, 0),
                                256, 2))
    steps = 255
    wants = {"perplexity": {"K1": 4 * L, "K2": 1, "K4": L},
             "decode_perplexity": {"K1": 4 * L * steps, "K2": steps,
                                   "K3": L * steps}}
    res = {}
    for fn in (perplexity, decode_perplexity):
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res[fn.__name__] = fn(cfg, params, batches, device=dev,
                              use_kernel=True)
        torch.cuda.synchronize()
        res[f"{fn.__name__}_s"] = time.perf_counter() - t0
        got = {k: n for k, n in counts().items() if n}
        if got != wants[fn.__name__]:
            raise AssertionError(f"{fn.__name__} launched {got}")
    fwd, dec = res["perplexity"], res["decode_perplexity"]
    rel = abs(dec - fwd) / fwd
    if not (math.isfinite(fwd) and math.isfinite(dec) and rel <= PPL_RTOL):
        raise AssertionError(f"perplexity {fwd}, decode_perplexity {dec}: "
                             f"relative difference {rel:.4g} over "
                             f"{PPL_RTOL}")
    log(f"perplexity (OPT-1.3B int4, 2 x 256 synthetic tokens): forward "
        f"{fwd:.4f} in {res['perplexity_s']:.3f} s, decode path {dec:.4f} "
        f"in {res['decode_perplexity_s']:.3f} s ({steps} graph steps); "
        f"relative difference {rel:.4g} (<= {PPL_RTOL}); launches "
        f"{wants} ({card})")
    res["ppl_rel_diff"] = rel
    return res


def run_benches(cfg, trace_dir):
    """The benches at OPT-1.3B, briefly: attn_bench under each
    flash-decode schedule (K11, K12, K13), profile_decode's split of the
    int4 'pair' step (trace into ``trace_dir``/profile_decode) and of the
    NF4 'plane' step (``trace_dir``/profile_decode_nf4), and its
    attn_only variant on the 'ew' and batch-folded split routes, at
    positions 272-287 (the last 16 rows of a 288-row cache; phase 3 times
    decode at ctx 256-288), kernel_bench on the four decode shapes, and
    prefill_bench on the int4 'pair' model's 256-bucket group (4 x 256;
    trace of one prefill into ``trace_dir``/prefill). The split's residual
    (norms, embedding, glue) must be positive: a negative one means the
    variants timed different work. Their result lines go to stdout.
    Returns the results."""
    out = {}
    for mode, knobs in (("dot", {}), ("ew", {"FLASH_MHA_MODE": "ew"}),
                        ("bfold", {"FLASH_BATCH_FOLD": True})):
        with split_route(**knobs):
            out[f"attn_bench_{mode}"] = attn_bench.main(
                ["--model", "opt-1.3b", "--iters", "16"])
    at_ctx = ["--model", "opt-1.3b", "--steps", "16", "--ctx", "288"]
    for key, extra in (("profile_decode", []),
                       ("profile_decode_nf4",
                        ["--layout", "plane", "--codebook", "nf4"])):
        out[key] = profile = profile_decode.main(
            at_ctx + extra + ["--trace", os.path.join(trace_dir, key)])
        if not profile["ms_per_step"]["residual"] > 0:
            raise AssertionError(f"{key}: residual "
                                 f"{profile['ms_per_step']['residual']:.3f} "
                                 "ms is not positive")
    for mode, knobs in (("ew", {"FLASH_MHA_MODE": "ew"}),
                        ("bfold", {"FLASH_BATCH_FOLD": True})):
        with split_route(**knobs):
            out[f"profile_decode_attn_only_{mode}"] = profile_decode.main(
                at_ctx + ["--variants", "attn_only"])
    out["kernel_bench"] = kernel_bench.main(["--iters", "64"])
    t0 = time.perf_counter()
    out["prefill_bench"] = pre = prefill_bench.main(
        ["--model", "opt-1.3b", "--batch", "4", "--seq", "256", "--reps",
         "3", "--modes", "ours,xla", "--trace",
         os.path.join(trace_dir, "prefill")])
    out["prefill_bench_s"] = time.perf_counter() - t0
    check_prefill_bench(pre)
    k10 = [row for row in pre["trace"]["kernels"]
           if "append_kernel" in row[0]]
    if (len(k10) != 1 or k10[0][2] != cfg.n_layers
            or any(pre["trace"]["quant_ops"].values())):
        raise AssertionError(f"prefill_bench trace: K10 {k10}, the "
                             f"quantizer's ops {pre['trace']['quant_ops']}")
    log(f"prefill_bench trace: K10 (append_kernel) {k10[0][1]:.4f} ms in "
        f"{k10[0][2]} launches of {pre['trace']['device_ms']:.3f} ms of "
        f"device time; no PyTorch quantizer op ran")
    log(f"benches (OPT-1.3B, {cfg.n_layers} layers): "
        f"{json.dumps(out, default=str)}")
    return out


def check_prefill_bench(pre):
    """prefill_bench's matmul section and attention-route A/B: every form
    (K1/K7, dequantize + ``torch.matmul``, ``torch.matmul`` on the bf16
    weight) within the bf16 tolerance of the f32 product at every case,
    and the 'xla' route's prefill logits within a relative L2 of 2^-6 of
    K4's ('ours')."""
    rows = pre["matmul"]
    if len(rows) != (len(prefill_bench.MATMUL_GEOMS)
                     * len(prefill_bench.MATMUL_BITS)
                     * len(prefill_bench.MATMUL_MS)):
        raise AssertionError(f"prefill_bench: {len(rows)} matmul cases")
    for r in rows:
        bad = [f for f, ok in r["within"].items() if not ok]
        if bad or set(r["within"]) != set(prefill_bench.MATMUL_FORMS):
            raise AssertionError(
                f"prefill_bench {r['geom']} int{r['nbits']} M={r['M']}: "
                f"{bad} beyond the bf16 tolerance of the f32 product "
                f"(max |err| {r['err']})")
    modes = pre["modes"]
    if set(modes) != {"ours", "xla"} or not modes["xla"]["rel_l2"] <= 2 ** -6:
        raise AssertionError(f"prefill_bench --modes: {modes}")
    log("prefill_bench matmul section (ms: pair, deq+mm, dense; MFU of the "
        "faster of pair and deq+mm against 989 TFLOP/s): " + json.dumps(
            [[r["geom"], r["nbits"], r["M"], round(r["pair_ms"], 4),
              round(r["deq+mm_ms"], 4), round(r["dense_ms"], 4),
              round(r["mfu"], 4)] for r in rows])
        + f"; crossover (the first M where deq+mm beats pair) "
        f"{json.dumps(pre['crossover'])}; every form within the bf16 "
        f"tolerance of the f32 product")
    log(f"prefill_bench --modes: ours (K4) {modes['ours']['ms']:.3f} ms, xla "
        f"(_attention) {modes['xla']['ms']:.3f} ms; xla's logits "
        f"{modes['xla']['rel_l2']:.3g} from ours' (relative L2, <= 2^-6)")


# ---- phase 7: the 3-bit and 'plane' layouts through the Engine (K6-K9) -----


LAYOUT_NEW_TOKENS = 16


def repack(tree, layout, src):
    """``tree`` with every ``src``-layout PackedLinear's indices repacked
    as ``layout`` on its device (unpack_indices / pack_indices)."""
    if isinstance(tree, PackedLinear) and tree.layout == src:
        idx = unpack_indices(tree.packed, tree.nbits, tree.in_features, src)
        return dataclasses.replace(
            tree, packed=pack_indices(idx, tree.nbits, layout=layout),
            layout=layout)
    if isinstance(tree, dict):
        return {k: repack(v, layout, src) for k, v in tree.items()}
    if isinstance(tree, list):
        return [repack(v, layout, src) for v in tree]
    return tree


def run_layouts(dev, cfg, card, state):
    """The int3 'pair3x' model (K6), its indices repacked as 'pair3' (K7),
    the NF4 'plane' model (K8), each served as ``serve`` says; then
    the int4 model's indices repacked as 'plane' (K9). Returns (each
    kernel's launches on its path, metrics)."""
    prompts = state["prompts"]
    launches, metrics = {}, {}
    t0 = time.perf_counter()
    p3x, _ = random_packed_params(cfg, seed=0, fuse_qkv=True,
                                  codebook=UniformCodebook(8, -1.0, 1.0),
                                  layout="pair3x", device=dev)
    p3x = pack_lm_head(cfg, p3x, nbits=8)
    torch.cuda.synchronize()
    log(f"random int3 pair3x params + int8 head: "
        f"{time.perf_counter() - t0:.1f} s")
    run, m, full_p3x, _, _ = serve(dev, cfg, card, "int3", p3x, K6, prompts,
                                   LAYOUT_NEW_TOKENS)
    launches["K6"] = run["K6"]
    metrics.update(m)
    p3 = repack(p3x, "pair3", "pair3x")
    del p3x
    run, m, full_p3, _, _ = serve(dev, cfg, card, "int3p", p3, K7, prompts,
                                  LAYOUT_NEW_TOKENS)
    launches["K7"] = run["K7"]
    metrics.update(m)
    rel, agree = rel_l2(full_p3, full_p3x, "pair3 vs pair3x prefill logits")
    metrics["int3p_vs_int3_rel_l2"] = rel
    log(f"int3p vs int3 (the same indices through K7 and K6): {cfg.n_layers}"
        f" layers relative L2 {rel:.4g} (<= 2^-6), argmax agreement "
        f"{agree:.4f}")
    del p3, full_p3, full_p3x

    nf4, _ = random_packed_params(cfg, seed=0, fuse_qkv=True,
                                  codebook=Codebook.nf4(), layout="plane",
                                  device=dev)
    nf4 = pack_lm_head(cfg, nf4, nbits=8)
    # The random NF4 model drifts: its table's mean is +0.023, so uniform
    # random indices bias every layer the same way, and the kernels' and
    # plain versions' bf16 differences grow with depth past 2^-6. So its
    # full-depth logits are measured (and at 8 layers), its 24 layers held
    # one by one, and K8's full depth is held on the same indices over the
    # NF4 table with its mean taken out, a model that does not drift.
    run, m, _, _, _ = serve(dev, cfg, card, "nf4", nf4, K8, prompts,
                            LAYOUT_NEW_TOKENS, hold=False, compare=True)
    launches["K8"] = run["K8"]
    metrics.update(m)
    toks = group_tokens(prompts, dev)

    def kernels_vs_plain(params, n_layers, what, hold):
        return rel_l2(prefill_logits(dev, cfg, params, toks, n_layers, True),
                      prefill_logits(dev, cfg, params, toks, n_layers, False),
                      what, hold)[0]
    rel8 = kernels_vs_plain(nf4, 8, "nf4 8 layers", False)
    del nf4
    values = Codebook.nf4().values
    centred, _ = random_packed_params(
        cfg, seed=0, fuse_qkv=True, layout="plane", device=dev,
        codebook=Codebook.create((values - values.mean()).numpy()))
    centred = pack_lm_head(cfg, centred, nbits=8)
    rel_c = kernels_vs_plain(centred, cfg.n_layers,
                             "centred NF4 prefill logits", True)
    del centred
    metrics.update(nf4_prefill_8_layers_rel_l2=rel8,
                   nf4_centred_prefill_full_rel_l2=rel_c)
    log(f"nf4 prefill logits, kernels vs plain versions: 8 layers relative "
        f"L2 {rel8:.4g} (measured); the same indices over the table minus "
        f"its mean: {cfg.n_layers} layers relative L2 {rel_c:.4g} (<= 2^-6)")

    # int4 'plane': the int4 model's own indices, so the 'pair' path (K1)
    # is the reference for its logits; decode over the int4 Engine's cache.
    plane = repack(state["params"], "plane", "pair")
    kernels.reset_launch_counts()
    got = prefill_logits(dev, cfg, plane, toks, cfg.n_layers, True)
    torch.cuda.synchronize()
    pre_launches = counts()["K9"]
    if counts()["K10"] != cfg.n_layers:
        raise AssertionError(f"int4 plane: the prefill launched "
                             f"{counts()['K10']} K10")
    want = prefill_logits(dev, cfg, state["params"], toks, cfg.n_layers,
                          True)
    rel, agree = rel_l2(got, want, "int4 plane vs pair prefill logits")
    layers_err = check_layers(dev, cfg, plane, toks, "int4 plane ")
    cache = {k: v.clone() for k, v in state["cache"].items()}
    last = torch.zeros(8, dtype=torch.int32, device=dev)
    steps = 4
    # decode_scan: one eager step, the capture, three replays.
    kernels.reset_launch_counts()
    decode_scan(cfg, plane, cache, last, 256, steps, use_kernel=True)
    torch.cuda.synchronize()
    step = {k: n for k, n in counts().items() if n}
    want_step = {"K9": 4 * cfg.n_layers * steps, "K2": steps,
                 "K3": cfg.n_layers * steps}
    if step != want_step or pre_launches != 4 * cfg.n_layers:
        raise AssertionError(f"int4 plane: {pre_launches} K9 in prefill, "
                             f"{steps} decode steps launched {step}")
    launches["K9"] = pre_launches + step["K9"]
    log(f"int4 plane: prefill {pre_launches} K9, {steps} decode steps "
        f"launch {step}; prefill logits vs the pair (K1) path on the same "
        f"indices: {cfg.n_layers} layers relative L2 {rel:.4g} (<= 2^-6), "
        f"argmax agreement {agree:.4f}")
    ms_step, loop_ms, dev_ms = time_decode(dev, cfg, plane, cache, card,
                                           "int4 plane decode")
    metrics.update(int4_plane_vs_pair_rel_l2=rel,
                   int4_plane_layers_max_err=layers_err,
                   int4_plane_decode_ms_per_step=ms_step,
                   int4_plane_decode_loop_graph_ms_per_step=loop_ms,
                   int4_plane_decode_step_graph_ms=dev_ms)
    return launches, metrics


# ---- phase 10: the quantizer on bf16 OPT-1.3B ------------------------------

# The JAX CLI's calibration defaults: 16 samples x 256 tokens, batch 2.
CALIB_SAMPLES, CALIB_LEN, CALIB_BATCH = 16, 256, 2
# The quantize phase's layers of OPT-1.3B at full width: the CLI phase
# solves all 24.
QUANT_DEPTH = 2


def make_prompts(cfg):
    """The Engine runs' 8 prompts (PROMPT_LENS, numpy seed 1)."""
    rng = np.random.default_rng(1)
    return [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
            for n in PROMPT_LENS]


def shape_of(name):
    return {"fc1": "fc1 2048->8192", "fc2": "fc2 8192->2048"}.get(
        name.split(".")[-1], "q/k/v/o 2048->2048")


@contextlib.contextmanager
def patched(owner, name, wrap):
    """``owner.name`` replaced by ``wrap(inner)`` inside the block."""
    inner = getattr(owner, name)
    setattr(owner, name, wrap(inner))
    try:
        yield
    finally:
        setattr(owner, name, inner)


def record_multipliers(mults):
    """A wrapper of ``hessian_inv_chol_robust`` that appends each call's
    dampening multiplier to ``mults`` (one a layer: a batched call returns
    a list)."""
    def wrap(inner):
        def robust(*a, **kw):
            hinv, mult = inner(*a, **kw)
            mults.extend(mult if isinstance(mult, list) else [mult])
            return hinv, mult
        return robust
    return wrap


def run_quantize(dev, cfg, card):
    """The quantizer's main path on the card: dense bf16 OPT-1.3B at full
    width (random weights from seed 0, ``cfg``'s layers: QUANT_DEPTH)
    calibrated on the JAX CLI's defaults (16 x 256 tokens of
    ``synthetic_stream``, batch 2: exactly one K4 launch a layer a batch),
    every one of its linears quantized (light,
    4 bits, packed, with a resume directory; the statistics freed as the
    solves finish), then the resume pass (nothing solved: the dequantized
    dense model of the same solve, to which every packed linear
    dequantizes); the four methods on layer 0's six
    linears (each GPTQ-based one below round-to-nearest); layer 0's fc1
    on the card against the port on the CPU; the packed model (q|k|v
    fused, int8 head) served through the slot Engine as ``serve`` does
    (K1, K2, K3, K4, K10, replay-counted; graph vs eager tokens), and its
    prefill logits against the dequantized dense model's; one fc2 solve
    under ``torch.profiler``. Returns the phase's metrics."""
    m = {}
    t0 = time.perf_counter()
    params = tr.init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    log(f"quantize: dense bf16 OPT-1.3B (seed 0, {cfg.n_layers} layers): "
        f"{time.perf_counter() - t0:.1f} s ({card})")

    stream = synthetic_stream(cfg.vocab_size, CALIB_SAMPLES * CALIB_LEN,
                              seed=0)
    batches = calibration_batches(stream, CALIB_SAMPLES, CALIB_LEN,
                                  CALIB_BATCH)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    stats = calibrate(cfg, params, batches)
    torch.cuda.synchronize()
    m["calibrate_s"] = time.perf_counter() - t0
    launches = {k: n for k, n in counts().items() if n}
    want = {"K4": cfg.n_layers * len(batches)}
    if launches != want:
        raise AssertionError(f"calibration launched {launches}, not {want}")
    nbytes = {"fc2": 0, "rest": 0}
    for name, st in stats.items():
        key = "fc2" if name.endswith("fc2") else "rest"
        nbytes[key] += st.hessian.numel() * 4 + st.mean.numel() * 4
        if not torch.isfinite(st.hessian).all():
            raise AssertionError(f"calibration: {name}'s Hessian not finite")
    m["calibrate_launches"] = launches
    m["stats_bytes_fc2"], m["stats_bytes_rest"] = nbytes["fc2"], nbytes["rest"]
    log(f"quantize: calibration ({CALIB_SAMPLES} x {CALIB_LEN} tokens, "
        f"batch {CALIB_BATCH}) {m['calibrate_s']:.3f} s, launches "
        f"{launches}; statistics {nbytes['fc2'] / 1e9:.3f} GB fc2, "
        f"{nbytes['rest'] / 1e9:.3f} GB the rest ({card})")

    qcfg = preset_config("light", nbits=4)
    layer0 = {n: stats[n] for n in tr.layer_names(cfg)
              if n.startswith("layers.0.")}
    # The batched route's statistics: the serial run frees its entries.
    batched_stats = dict(stats)
    mults = []
    with tempfile.TemporaryDirectory(prefix="quantize_resume_") as resume:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with patched(solver_mod, "hessian_inv_chol_robust",
                     record_multipliers(mults)):
            packed, reports = quantize_model(cfg, params, stats, qcfg,
                                             pack=True, resume_dir=resume,
                                             free_stats=True)
        torch.cuda.synchronize()
        m["quantize_s"] = time.perf_counter() - t0
        m["quantize_peak_bytes"] = torch.cuda.max_memory_allocated()
        if stats or len(reports) != 6 * cfg.n_layers or len(mults) != len(
                reports):
            raise AssertionError("quantize: not every linear solved once")
        by_shape = {}
        for r in reports:
            if not math.isfinite(r.error):
                raise AssertionError(f"quantize: {r.name}'s error {r.error}")
            row = by_shape.setdefault(shape_of(r.name),
                                      dict(n=0, s=0.0, error=0.0))
            row["n"] += 1
            row["s"] += r.wall_s
            row["error"] += r.error
        m["quantize_by_shape"] = by_shape
        m["damp_retries"] = sum(x > 1.0 for x in mults)
        m["damp_multipliers"] = sorted(set(mults))
        log(f"quantize: {len(reports)} linears (light, 4 bits, packed) in "
            f"{m['quantize_s']:.3f} s, {m['damp_retries']} solves with a "
            f"damping retry (multipliers {m['damp_multipliers']}); by shape "
            + json.dumps(by_shape) + f" ({card})")
        log(f"quantize: serial route: {m['quantize_s']:.3f} s wall, one "
            f"layer a solve, peak {m['quantize_peak_bytes'] / 1e9:.3f} GB "
            f"allocated ({card})")
        t0 = time.perf_counter()
        dense_q, again = quantize_model(cfg, params, {}, qcfg,
                                        resume_dir=resume)
        torch.cuda.synchronize()
        m["resume_s"] = time.perf_counter() - t0
        if any(r.wall_s != 0.0 for r in again):
            raise AssertionError("quantize: the resume pass solved a layer")
        log(f"quantize: the resume pass loaded all {len(again)} artifacts "
            f"and solved none: {m['resume_s']:.3f} s ({card})")
    worst = 0.0
    for name in tr.layer_names(cfg):
        deq = tr.get_linear_param(packed, name).dequantize()
        ref = tr.get_linear_param(dense_q, name)["kernel"]
        worst = max(worst, ((deq - ref).abs().max() / ref.abs().max()).item())
    m["packed_dequant_max_rel"] = worst
    if not worst <= 1e-6:
        raise AssertionError(f"quantize: a packed linear dequantizes "
                             f"{worst:.3g} away from its solved Q")
    log(f"quantize: every packed linear dequantizes to the resume pass's Q "
        f"(max |err| {worst:.3g} of its largest entry)")

    fc2 = [n for n in tr.layer_names(cfg) if n.endswith(".fc2")]
    fc2_stats = [batched_stats[n] for n in fc2]
    batched, batched_m = run_layer_parallel(cfg, params, batched_stats,
                                            packed, reports, card)
    m.update(batched_m)
    m.update(compare_presets(cfg, params, layer0, card))
    m.update(card_vs_cpu(cfg, params, layer0["layers.0.fc1"], card))
    st = layer0["layers.0.fc2"]
    m.update(profile_solve(
        tr.get_linear_param(params, "layers.0.fc2")["kernel"].T.float(),
        st.hessian, st.mean, "fc2", card))
    m.update(profile_solve(
        torch.stack([tr.get_linear_param(params, n)["kernel"].T.float()
                     for n in fc2]),
        torch.stack([st.hessian for st in fc2_stats]),
        torch.stack([st.mean for st in fc2_stats]), "fc2_chunk", card))
    del layer0, fc2_stats

    packed = pack_lm_head(cfg, tr.fuse_qkv_params(cfg, packed), nbits=8)
    del params
    torch.cuda.empty_cache()
    for layer in packed["layers"]:
        for p in (*layer["attn"].values(), *layer["mlp"].values()):
            if not (isinstance(p, PackedLinear) and p.layout == "pair"
                    and p.nbits == 4):
                raise AssertionError("quantize: a linear is not int4 'pair'")
    head = packed["lm_head"]
    if not (isinstance(head, PackedLinear) and head.layout == "int8"):
        raise AssertionError("quantize: the head is not int8")
    prompts = make_prompts(cfg)
    _, served, full, engine, comps = serve(dev, cfg, card, "quant", packed,
                                           K1, prompts, NEW_TOKENS,
                                           compare=True)
    del engine, full
    m.update(served)
    batched = pack_lm_head(cfg, tr.fuse_qkv_params(cfg, batched), nbits=8)
    _, _, full, engine, batched_comps = serve(
        dev, cfg, card, "quant batched", batched, K1, prompts, NEW_TOKENS)
    del engine, full, batched
    agree = np.mean([np.mean(np.asarray(a.tokens) == np.asarray(b.tokens))
                     for a, b in zip(batched_comps, comps)])
    m["batched_served_token_agreement"] = float(agree)
    if m["batched_words_equal"] and agree != 1.0:
        raise AssertionError("quantize: the batched route's words equal the "
                             "serial route's, its served tokens do not")
    log(f"quantize: the batched route's packed model served as the serial "
        f"one is; greedy tokens {agree:.4f} equal to the serial model's")
    toks = group_tokens(prompts, dev)
    got = prefill_logits(dev, cfg, packed, toks, cfg.n_layers, True)
    want = prefill_logits(dev, cfg, dense_q, toks, cfg.n_layers, False)
    rel, agree = rel_l2(got, want, "quantize: packed prefill logits vs the "
                        "dequantized dense model")
    m["packed_vs_dense_rel_l2"], m["packed_vs_dense_argmax_agree"] = rel, agree
    log(f"quantize: the packed model's prefill logits (kernels) against the "
        f"dequantized dense model's (plain versions), {cfg.n_layers} layers: "
        f"relative L2 {rel:.4g} (<= 2^-6), argmax agreement {agree:.4f}")
    return m


# The batched route against the serial one on the card: the two round in
# other places (the sqerr order's column sums reduce in another order
# over L lanes, which can swap near-tied columns; cuSOLVER's batched
# Cholesky and cuBLAS's batched triangular solve and GEMMs round Hinv and
# the trailing updates otherwise), and the sweep carries a flipped
# rounding decision along its row, longest in fc2's 8,192 columns. A
# wrong lane, order or factor would miss these bounds by orders of
# magnitude; on the CPU the two routes are bit for bit equal.
BATCHED_LAYER_RTOL, BATCHED_MIN_SHARE, BATCHED_TOTAL_RTOL = 2e-3, 0.95, 1e-4


def route_distance(ref, ref_reports, packed, reports):
    """``packed``'s linears against ``ref``'s: (each layer's error
    distance, its share of equal packed codewords, the summed error's
    distance, whether every packed word is equal)."""
    rels, shares, equal = {}, {}, True
    for rs, rp in zip(ref_reports, reports):
        rels[rs.name] = abs(rp.error - rs.error) / rs.error
        a, b = (tr.get_linear_param(p, rs.name) for p in (ref, packed))
        ia, ib = (unpack_indices(p.packed, p.nbits, p.in_features, p.layout)
                  for p in (a, b))
        shares[rs.name] = (ia == ib).float().mean().item()
        equal = equal and torch.equal(a.packed, b.packed)
    total_s = sum(r.error for r in ref_reports)
    total_rel = abs(sum(r.error for r in reports) - total_s) / total_s
    return rels, shares, total_rel, equal


def route_gate(what, whose, rels, shares, total_rel,
               layer_rtol=BATCHED_LAYER_RTOL, min_share=BATCHED_MIN_SHARE,
               total_rtol=BATCHED_TOTAL_RTOL):
    """Fails unless every layer's error is within ``layer_rtol`` of
    ``whose`` with at least ``min_share`` of its codewords equal, and the
    summed error within ``total_rtol`` (by default the batched route's
    gates)."""
    for name, rel in rels.items():
        if not (rel <= layer_rtol and shares[name] >= min_share):
            raise AssertionError(f"{what}: {name}'s error {rel:.3g} from "
                                 f"{whose}, {shares[name]:.4f} of its "
                                 f"codewords equal")
    if not total_rel <= total_rtol:
        raise AssertionError(f"{what}: the summed error {total_rel:.3g} "
                             f"from {whose}")


def run_layer_parallel(cfg, params, stats, serial, serial_reports, card):
    """The same linears through ``quantize_model(layer_parallel=True,
    pack=True, free_stats=True)``: each shape group solved as stacks in
    chunks that fit the card, no kernel launched. Against the serial
    route: every layer's error within BATCHED_LAYER_RTOL and at least
    BATCHED_MIN_SHARE of its packed codewords equal, the summed error
    within BATCHED_TOTAL_RTOL; one damping multiplier a layer. Returns
    (the packed params, metrics: wall, each group's chunk sizes, peak
    memory, the errors' and codewords' distance)."""
    qcfg = preset_config("light", nbits=4)
    chunks, mults = {}, []

    def record(inner):
        def batch(params, stats, group, *a):
            chunks.setdefault(shape_of(group[0]), []).append(len(group))
            return inner(params, stats, group, *a)
        return batch

    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with patched(quant_mod, "_solve_layer_batch", record), patched(
            solver_mod, "hessian_inv_chol_robust", record_multipliers(mults)):
        packed, reports = quantize_model(cfg, params, stats, qcfg, pack=True,
                                         layer_parallel=True,
                                         free_stats=True)
    torch.cuda.synchronize()
    m = {"batched_quantize_s": time.perf_counter() - t0,
         "batched_peak_bytes": torch.cuda.max_memory_allocated(),
         "batched_chunks": chunks,
         "batched_launches": {k: n for k, n in counts().items() if n}}
    if m["batched_launches"]:
        raise AssertionError(f"quantize batched: launched "
                             f"{m['batched_launches']}")
    if (stats or [r.name for r in reports] != [r.name for r in serial_reports]
            or len(mults) != len(reports)
            or sum(map(sum, chunks.values())) != len(reports)):
        raise AssertionError("quantize batched: not every linear solved once")
    rels, shares, total_rel, equal = route_distance(
        serial, serial_reports, packed, reports)
    route_gate("quantize batched", "the serial route's", rels, shares,
               total_rel)
    m.update(batched_error_rel=rels, batched_codeword_share=shares,
             batched_total_error_rel=total_rel, batched_words_equal=equal,
             batched_damp_multipliers=sorted(set(mults)))
    log(f"quantize: batched route (layer_parallel): "
        f"{m['batched_quantize_s']:.3f} s wall, chunks by shape "
        + json.dumps(chunks) + f", peak {m['batched_peak_bytes'] / 1e9:.3f} "
        f"GB allocated; against the serial route: summed error "
        f"{total_rel:.3g} apart (<= {BATCHED_TOTAL_RTOL:g}), each layer's "
        f"within {max(rels.values()):.3g} (<= {BATCHED_LAYER_RTOL:g}), "
        f"codewords equal {min(shares.values()):.5f} at worst (>= "
        f"{BATCHED_MIN_SHARE:g}), packed words all equal: {equal}; damping "
        f"multipliers {m['batched_damp_multipliers']} ({card})")
    log("quantize: batched vs serial by layer [error rel, codeword share] "
        + json.dumps({n: [round(rels[n], 7), round(shares[n], 5)]
                      for n in rels}))
    return packed, m


def compare_presets(cfg, params, layer0, card):
    """Round-to-nearest (the non-saturating scale) and the basic, light
    and heavy presets (4 bits) on layer 0's six linears, each scored on
    the Hessian its preset optimizes (light and heavy: bias-corrected);
    round-to-nearest on both. Every GPTQ-based error must be below
    round-to-nearest's on its Hessian. Returns the summed errors."""
    cb = preset_config("basic", nbits=4).make_codebook()
    errs = {k: 0.0 for k in ("rtn", "rtn_bias_corrected", "basic", "light",
                             "heavy")}
    t0 = time.perf_counter()
    for name, st in layer0.items():
        W = tr.get_linear_param(params, name)["kernel"].T.float()
        H_bc = remove_input_bias(st.hessian, st.mean)
        scale = compute_non_saturating_scaling(W, cb)
        Q = cb(W / scale[:, None]) * scale[:, None]
        rtn = float(channelwise_error(W, Q, st.hessian).sum())
        rtn_bc = float(channelwise_error(W, Q, H_bc).sum())
        errs["rtn"] += rtn
        errs["rtn_bias_corrected"] += rtn_bc
        for preset in ("basic", "light", "heavy"):
            err = float(quantize_layer(W, st.hessian, st.mean,
                                       preset_config(preset, nbits=4))[3]
                        .sum())
            if not err < (rtn if preset == "basic" else rtn_bc):
                raise AssertionError(f"quantize: {preset} on {name} "
                                     f"({err:.6g}) is not below "
                                     f"round-to-nearest")
            errs[preset] += err
    order = " < ".join(sorted(("heavy", "light", "basic", "rtn"),
                              key=errs.get))
    log(f"quantize: layer 0's six linears, 4 bits, summed errors "
        + json.dumps(errs) + f": {order} (each below round-to-nearest on "
        f"its Hessian; {time.perf_counter() - t0:.1f} s, {card})")
    return {"layer0_errors": errs, "layer0_order": order}


def card_vs_cpu(cfg, params, st, card):
    """Layer 0's fc1 (8192 x 2048) through quantize_layer (light, 4 bits)
    on the card and in the port on the CPU from the same tensors: the
    objective within 1e-3 relative and at least 99% of Q's codewords
    equal."""
    qcfg = preset_config("light", nbits=4)
    W = tr.get_linear_param(params, "layers.0.fc1")["kernel"].T.float()
    t0 = time.perf_counter()
    card_out = quantize_layer(W, st.hessian, st.mean, qcfg)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu_out = quantize_layer(W.cpu(), st.hessian.cpu(), st.mean.cpu(), qcfg)
    cpu_s = time.perf_counter() - t0
    e_card, e_cpu = float(card_out[3].sum()), float(cpu_out[3].sum())
    cb = qcfg.make_codebook()
    same = (cb.quantize_index((card_out[0] / card_out[2][:, None]).cpu())
            == cb.quantize_index(cpu_out[0] / cpu_out[2][:, None]))
    share = same.float().mean().item()
    rel = abs(e_card - e_cpu) / e_cpu
    if not (rel <= 1e-3 and share >= 0.99):
        raise AssertionError(f"quantize: fc1 on the card vs the CPU: "
                             f"objective {rel:.3g} apart, {share:.4f} of Q "
                             f"equal")
    log(f"quantize: layer 0's fc1 on the card vs the CPU (light, 4 bits): "
        f"objective {e_card:.6g} vs {e_cpu:.6g} ({rel:.3g} apart), "
        f"{share:.5f} of Q's codewords equal; {card_s:.3f} s on the card "
        f"({card}), {cpu_s:.1f} s on the CPU")
    return {"fc1_card_vs_cpu_rel": rel, "fc1_card_vs_cpu_same": share,
            "fc1_card_s": card_s, "fc1_cpu_s": cpu_s}


def timed_phase(name):
    """A wrapper that runs a function as one phase of a profiled solve:
    synchronized at both ends, under ``record_function(name)``."""
    def wrap(inner):
        def phase(*a, **kw):
            torch.cuda.synchronize()
            with torch.profiler.record_function(name):
                out = inner(*a, **kw)
                torch.cuda.synchronize()
            return out
        return phase
    return wrap


PHASES = (("scaling", pipe_mod, "compute_scaling"),
          ("order", solver_mod, "compute_order"),
          ("cholesky", solver_mod, "hessian_inv_chol_robust"),
          ("sweep", solver_mod, "gptq_sweep"))


def profile_solve(W, H, mean, what, card):
    """A solve through quantize_layer (light, 4 bits): one fc2 layer, W
    (2048, 8192), or a stack of them (L, 2048, 8192), the batched route's
    chunk: its wall time unprofiled, then once under ``torch.profiler``
    with each phase (scaling grid, ordering, Cholesky and inverse, the
    sweep) run between synchronizations: the device time of each phase,
    the sweep's split between the trailing GEMMs (kernels named ``gemm``)
    and the column loop (the rest), its launches a column, and the
    device's busy share of the unprofiled solve (trace under the
    git-ignored ``traces/quantize_<what>``). Returns metrics named
    ``<what>_...``."""
    qcfg = preset_config("light", nbits=4)
    quantize_layer(W, H, mean, qcfg)      # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    quantize_layer(W, H, mean, qcfg)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with contextlib.ExitStack() as stack:
        for name, owner, attr in PHASES:
            stack.enter_context(patched(owner, attr, timed_phase(name)))
        with device_trace(os.path.join(ROOT, "traces",
                                       f"quantize_{what}")) as prof:
            quantize_layer(W, H, mean, qcfg)
            torch.cuda.synchronize()
    events = prof.events()
    names = {name for name, _, _ in PHASES}
    ranges = {e.name: (e.time_range.start, e.time_range.end)
              for e in events if e.name in names}
    # The card's events, less the phases' own ranges, which the trace
    # also draws on the card's timeline (over their kernels).
    dev_events = [e for e in events
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and e.name not in names]
    split = {name: 0.0 for name, _, _ in PHASES}
    split.update(sweep_gemm=0.0, sweep_columns=0.0, other=0.0)
    sweep_launches = 0
    for e in dev_events:
        ms = (e.time_range.end - e.time_range.start) / 1e3
        phase = next((n for n, (a, b) in ranges.items()
                      if a <= e.time_range.start <= b), "other")
        if phase == "sweep":
            sweep_launches += 1
            phase = ("sweep_gemm" if "gemm" in e.name.lower()
                     else "sweep_columns")
        split[phase] += ms
    del split["sweep"]
    if set(ranges) != names or not sweep_launches:
        raise AssertionError(f"quantize profile: phases {sorted(ranges)}, "
                             f"{sweep_launches} sweep launches")
    device_ms = sum(split.values())
    n_cols = W.shape[-1]
    lanes = W.shape[0] if W.ndim == 3 else 1
    out = {f"{what}_solve_wall_ms": wall_ms,
           f"{what}_solve_device_ms": device_ms,
           f"{what}_busy": device_ms / wall_ms,
           f"{what}_launches_per_column": sweep_launches / n_cols,
           f"{what}_device_ms_by_phase": split}
    log(f"quantize: {what}: {lanes} fc2 solve(s) at once (light, 4 bits, "
        f"{W.shape[-2]} x {n_cols}): {wall_ms:.1f} ms wall unprofiled, "
        f"{device_ms:.1f} ms on the card (busy {out[f'{what}_busy']:.3f}); "
        f"{out[f'{what}_launches_per_column']:.2f} launches a column in the "
        f"sweep; device ms by phase "
        + json.dumps({k: round(v, 3) for k, v in split.items()})
        + f" ({card})")
    return out


# ---- the user's two commands (the CLI phase) -------------------------------

CLI_ARGS = ["--preset", "light", "--nbits", "4"]
SERVE_ARGS = ["--kv", "int8", "--random", "8", "--prompt-len", "256",
              "--max-new-tokens", "32"]
# The lloyd, uniform, spill and drain runs' layers of OPT-1.3B (the NF4 run
# takes all 24).
CLI_DEPTH = 2


def hf_opt_state_dict(params, n_layers, dtype=torch.float16):
    """The inverse of ``models/hf.py`` ``convert_opt``: a dense port OPT
    tree (``"kernel"`` (in, out)) as an HF ``OPTForCausalLM`` state dict
    under ``facebook/opt-1.3b``'s key names, weights (out, in), as CPU
    tensors of ``dtype``."""
    pre = "model.decoder."
    sd = {pre + "embed_tokens.weight": params["embed"]["tokens"],
          pre + "embed_positions.weight": params["embed"]["pos"],
          pre + "final_layer_norm.weight": params["final_ln"]["scale"],
          pre + "final_layer_norm.bias": params["final_ln"]["bias"]}
    names = {"self_attn.q_proj": ("attn", "q"),
             "self_attn.k_proj": ("attn", "k"),
             "self_attn.v_proj": ("attn", "v"),
             "self_attn.out_proj": ("attn", "o"), "fc1": ("mlp", "fc1"),
             "fc2": ("mlp", "fc2")}
    for i in range(n_layers):
        layer, lp = params["layers"][i], f"{pre}layers.{i}."
        for hf, (group, ours) in names.items():
            sd[f"{lp}{hf}.weight"] = layer[group][ours]["kernel"].T
            sd[f"{lp}{hf}.bias"] = layer[group][ours]["bias"]
        for hf, ours in (("self_attn_layer_norm", "ln1"),
                         ("final_layer_norm", "ln2")):
            sd[f"{lp}{hf}.weight"] = layer[ours]["scale"]
            sd[f"{lp}{hf}.bias"] = layer[ours]["bias"]
    return {k: v.to("cpu", dtype).contiguous() for k, v in sd.items()}


def write_safetensors(path, tensors):
    """One safetensors file: the 8-byte little-endian header length, the
    JSON header (padded with spaces to 8 bytes), then each tensor's raw
    little-endian bytes."""
    kinds = {torch.float32: "F32", torch.float16: "F16",
             torch.bfloat16: "BF16"}
    header, offset = {}, 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        header[name] = {"dtype": kinds[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(len(head).to_bytes(8, "little"))
        f.write(head)
        for t in tensors.values():
            f.write(t.view(torch.uint8).numpy().data)


def write_hf_checkpoint(directory, sd, shards=2):
    """``sd`` as ``shards`` safetensors files of about equal bytes, in key
    order, with the ``model.safetensors.index.json`` that maps each key to
    its file. Returns the bytes written."""
    total = sum(t.numel() * t.element_size() for t in sd.values())
    files, cur, size = [], {}, 0
    for k, t in sd.items():
        cur[k] = t
        size += t.numel() * t.element_size()
        if (size >= total * (len(files) + 1) / shards
                and len(files) < shards - 1):
            files.append(cur)
            cur = {}
    files.append(cur)
    weight_map = {}
    for j, part in enumerate(files):
        fname = f"model-{j + 1:05d}-of-{len(files):05d}.safetensors"
        write_safetensors(os.path.join(directory, fname), part)
        weight_map.update({k: fname for k in part})
    with open(os.path.join(directory, "model.safetensors.index.json"),
              "w") as f:
        json.dump({"metadata": {"total_size": total},
                   "weight_map": weight_map}, f)
    return total


def leaves(tree, path=""):
    """(path, tensor) of every tensor of a dense params tree."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, f"{path}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from leaves(v, f"{path}/{i}")
    else:
        yield path, tree


def cli_calibrations(cfg, params, card):
    """``calibrate_spill`` against ``calibrate`` on the full f32 model and
    the CLI's calibration batches: every mean and Hessian at max |diff| 0
    (printed and held within 1e-6 relative otherwise), the spilled ones on
    the host. Returns metrics."""
    need = CALIB_SAMPLES * CALIB_LEN + 4096
    batches = calibration_batches(synthetic_stream(cfg.vocab_size, need, 0),
                                  CALIB_SAMPLES, CALIB_LEN, CALIB_BATCH)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = calibrate(cfg, params, batches)
    torch.cuda.synchronize()
    cal_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = calibrate_spill(cfg, params, batches)
    spill_s = time.perf_counter() - t0
    worst = 0.0
    for name, st in got.items():
        for f in ("mean", "hessian", "count"):
            g, w = getattr(st, f), getattr(want[name], f)
            if g.device.type != "cpu":
                raise AssertionError(f"cli: calibrate_spill left {name} on "
                                     f"{g.device}")
            diff = (g.to(w.device) - w).abs().max().item()
            if diff:
                rel = diff / w.abs().max().item()
                log(f"cli: calibrate_spill vs calibrate, {name} {f}: max "
                    f"|diff| {diff:.3g} ({rel:.3g} of its largest)")
                if not rel <= 1e-6:
                    raise AssertionError(f"cli: calibrate_spill's {name} {f} "
                                         f"{rel:.3g} from calibrate's")
            worst = max(worst, diff)
    log(f"cli: calibrate_spill vs calibrate on f32 OPT-1.3B ({len(got)} "
        f"entries, {CALIB_SAMPLES} x {CALIB_LEN} tokens): max |diff| "
        f"{worst:.3g}; calibrate {cal_s:.3f} s on the card, calibrate_spill "
        f"{spill_s:.3f} s with the statistics moved to page-locked host "
        f"memory ({card})")
    return {"spill_vs_calibrate_max_diff": worst, "calibrate_s": cal_s,
            "calibrate_spill_s": spill_s}


def cli_shard(tmp, cfg, m, card):
    """The CLI's calibration stream (its default: ``synthetic_stream``
    from seed 0, samples x seq_len + 4096 tokens) written as an SKT1 shard
    with the native ``write_shard`` and read back through
    ``load_token_stream`` (the native ``TokenShard.windows``): the same
    tokens, bit for bit, so the CLI runs given ``--tokens`` the shard solve
    on the inputs they solve on without it. Returns the shard's path."""
    need = CALIB_SAMPLES * CALIB_LEN + 4096
    want = synthetic_stream(cfg.vocab_size, need, 0)
    path = os.path.join(tmp, "calib.skt")
    t0 = time.perf_counter()
    write_shard(path, want)
    got, prov = load_token_stream(path, cfg.vocab_size, need)
    secs = time.perf_counter() - t0
    if prov != f"shard:{path}" or not np.array_equal(got, want) or (
            got.dtype != want.dtype):
        raise AssertionError(f"cli: the SKT1 shard read back {prov} "
                             f"{got.dtype} {got[:8]}, not the stream")
    m["shard"] = {"tokens": int(got.size), "bytes": os.path.getsize(path),
                  "write_read_s": secs}
    log(f"cli: the calibration stream ({got.size} tokens) as an SKT1 shard "
        f"({m['shard']['bytes']} bytes, u16) written by the native "
        f"write_shard and read back through load_token_stream "
        f"(TokenShard.windows) in {secs:.4f} s: bit for bit the stream; the "
        f"CLI runs read it with --tokens ({card})")
    return path


def plane_on_kernels():
    """A context in which ``dequant_matmul_ref`` raises for a 'plane'
    linear on a CUDA tensor: every such linear must run K8/K9 or K8f/K9f,
    never the plain route."""
    def wrap(inner):
        def ref(x, w):
            if x.is_cuda and w.layout == "plane":
                raise AssertionError(
                    f"a 'plane' linear ({w.in_features} x "
                    f"{w.out_features}, {x.dtype}) took dequant_matmul_ref "
                    "on the card")
            return inner(x, w)
        return ref
    return patched(dm, "dequant_matmul_ref", wrap)


@contextlib.contextmanager
def eval_launches(record):
    """Each ``perplexity`` and ``decode_perplexity`` call inside the block
    (the CLI imports them from ``models/eval.py`` when it runs) counted
    from zeroed launch counts: (name, its batches, its launches, through
    the replay accounting) appended to ``record``."""
    def counting(name):
        def wrap(inner):
            def fn(cfg, params, batches, *a, **kw):
                batches = list(batches)
                kernels.reset_launch_counts()
                out = inner(cfg, params, batches, *a, **kw)
                torch.cuda.synchronize()
                record.append((name, batches,
                               {k: n for k, n in counts().items() if n}))
                return out
            return fn
        return wrap
    with patched(eval_mod, "perplexity", counting("perplexity")), \
            patched(eval_mod, "decode_perplexity",
                    counting("decode_perplexity")):
        yield


def quantize_cli(out, model, hf_dir, extra=(), limit=None):
    """``quantize_model_cli.main`` as a user runs it (``limit``: the
    ``QUANT_HBM_LIMIT`` it reads), with the launches of its calibration
    and of each of its perplexity scorings (``eval_launches``), the card's
    peak memory, and ``dequant_matmul_ref`` raising for a 'plane' linear
    on the card. Returns (its result, calibration launches, the
    scorings' launches, peak bytes, seconds)."""
    calib, evals, reads = {}, [], []

    def count_reads(inner):
        def wrapped(*a, **kw):
            reads.append(1)
            return inner(*a, **kw)
        return wrapped

    def count_calibration(inner):
        def wrapped(*a, **kw):
            kernels.reset_launch_counts()
            out = inner(*a, **kw)
            torch.cuda.synchronize()
            calib.update({k: n for k, n in counts().items() if n})
            return out
        return wrapped

    if limit is not None:
        os.environ["QUANT_HBM_LIMIT"] = repr(float(limit))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        with patched(quant_mod, "calibrate", count_calibration), \
                patched(quant_mod, "calibrate_spill", count_calibration), \
                patched(TokenShard, "windows", count_reads), \
                eval_launches(evals), plane_on_kernels():
            res = quantize_model_cli.main(
                [out, "--model", model, "--checkpoint", hf_dir, *CLI_ARGS,
                 *extra])
    finally:
        os.environ.pop("QUANT_HBM_LIMIT", None)
    if "--tokens" in extra and len(reads) != 1:
        raise AssertionError(f"cli: the calibration shard was read through "
                             f"TokenShard.windows {len(reads)} times, not 1")
    torch.cuda.synchronize()
    return (res, calib, evals, torch.cuda.max_memory_allocated(),
            time.perf_counter() - t0)


def check_cli_reports(res, cfg, what):
    """Every linear solved once, with a finite error; no statistics entry
    left after the solves."""
    names = [r.name for r in res["reports"]]
    if sorted(names) != sorted(tr.layer_names(cfg)) or not all(
            math.isfinite(r.error) for r in res["reports"]):
        raise AssertionError(f"cli {what}: not every linear solved once "
                             f"with a finite error")
    if res["stats_left"]:
        raise AssertionError(f"cli {what}: statistics left after the "
                             f"solves: {res['stats_left']}")


def check_cli_eval(res, evals, cfg, kern, what):
    """The CLI's ``--eval-ppl``: its three scorings launched exactly the
    fp32 forward's K4 (one a layer a batch), the quantized forward's K4
    and, with ``kern`` (K8f: every linear 'plane' at f32), 6 ``kern`` a
    layer a batch, and the decode scoring's K3 (one a layer a step) and 6
    ``kern`` a layer a step (replay-counted; without ``kern`` the linears
    take the plain route, which launches nothing); decode within
    PPL_RTOL of forward. Returns (relative difference, launches)."""
    L = cfg.n_layers
    names = [e[0] for e in evals]
    if names != ["perplexity", "perplexity", "decode_perplexity"]:
        raise AssertionError(f"cli {what}: scorings {names}")
    nb = len(evals[1][1])
    steps = sum(np.asarray(b).shape[1] - 1 for b in evals[2][1])
    lin = {kern: 6 * L} if kern else {}
    want = [{"K4": L * nb},
            {"K4": L * nb, **{k: n * nb for k, n in lin.items()}},
            {"K3": L * steps, **{k: n * steps for k, n in lin.items()}}]
    got = [e[2] for e in evals]
    if got != want:
        raise AssertionError(f"cli {what}: the scorings launched {got}, not "
                             f"{want}")
    ppl = res["ppl"]
    rel = abs(ppl["decode"] - ppl["quantized"]) / ppl["quantized"]
    if not all(math.isfinite(v) for v in (ppl["fp32"], ppl["quantized"],
                                          ppl["decode"])) or not (
            rel <= PPL_RTOL):
        raise AssertionError(f"cli {what}: perplexities {ppl}: decode vs "
                             f"forward {rel:.4g} over {PPL_RTOL}")
    return rel, dict(zip(("fp32", "quantized", "decode"), got))


def run_quantize_cli(out, model, hf_dir, cfg, kind, card, extra=(),
                     kern=None):
    """The quantize command with ``--eval-ppl`` (and ``extra``) on
    ``model`` (``cfg``): calibration's K4 (one a layer a batch), every
    linear solved once and of ``kind`` on reload, the scorings as
    check_cli_eval holds them, no spill or offload (80 GB holds it).
    Returns (metrics, the packed linears)."""
    res, calib, evals, peak, secs = quantize_cli(
        out, model, hf_dir, ["--eval-ppl", *extra])
    want_k4 = {"K4": cfg.n_layers * CALIB_SAMPLES // CALIB_BATCH}
    if calib != want_k4:
        raise AssertionError(f"cli {kind}: calibration launched {calib}, not "
                             f"{want_k4}")
    check_cli_reports(res, cfg, f"{kind} run")
    if res["spill"] or res["offload"] != "none":
        raise AssertionError(f"cli {kind}: the run spilled or offloaded "
                             f"({res['spill']}, {res['offload']})")
    rel, launches = check_cli_eval(res, evals, cfg, kern, kind)
    words = packed_linears(out, cfg, kind)
    ppl = res["ppl"]
    m = dict(seconds=secs, peak_bytes=peak, timer=res["timer"],
             total_error=res["total_error"], calibrate_launches=calib,
             eval_launches=launches, ppl=ppl, ppl_decode_rel=rel,
             peak_estimate=res["peak"], layers=cfg.n_layers)
    log(f"cli: quantize_model_cli {kind} (f32 OPT-1.3B, {cfg.n_layers} "
        f"layers, from the HF checkpoint, light, 4 bits, --eval-ppl): "
        f"{secs:.1f} s; sections "
        + json.dumps({k: v["total_s"] for k, v in res["timer"].items()})
        + f"; calibration launches {calib}; {len(res['reports'])} linears, "
        f"total error {res['total_error']:.6g}; perplexity fp32 "
        f"{ppl['fp32']:.2f}, quantized {ppl['quantized']:.2f}, decode "
        f"{ppl['decode']:.2f} ({rel:.3g} apart, <= {PPL_RTOL}; the 0.01-ppl "
        f"warning {'fired' if ppl['warned'] else 'silent'}); the scorings' "
        f"launches {launches}; every linear {kind} on reload; peak device "
        f"memory {peak / 1e9:.3f} GB (the CLI's simulated solve peak "
        f"{res['peak'] / 1e9:.3f} GB) ({card})")
    return m, words


LINEAR_KINDS = {
    "int4 'pair'": lambda p: p.layout == "pair" and p.nbits == 4,
    "NF4 'plane'": lambda p: (
        p.layout == "plane" and p.nbits == 4 and p.affine is None
        and torch.equal(p.lut, Codebook.nf4().values)),
    "lloyd 'plane'": lambda p: (
        p.layout == "plane" and p.nbits == 4 and p.affine is None
        and p.lut.numel() == 16),
}


def packed_linears(path, cfg, kind="int4 'pair'"):
    """The packed linears of a checkpoint, by name, on the CPU; each must
    be of ``kind`` (LINEAR_KINDS)."""
    params, _ = load_packed_params(path, cfg=cfg, device="cpu")
    out = {n: tr.get_linear_param(params, n) for n in tr.layer_names(cfg)}
    for n, p in out.items():
        if not (isinstance(p, PackedLinear) and LINEAR_KINDS[kind](p)):
            raise AssertionError(f"cli: {path}'s {n} is not {kind}")
    return out


def same_words(got, want, what):
    """Each linear of ``got`` bit for bit ``want``'s (words, scales,
    bias); where one differs, says where and by how much."""
    bad = []
    for n, p in got.items():
        q = want[n]
        words = int((p.packed != q.packed).sum())
        sc = (p.scale - q.scale).abs().max().item()
        bias = (p.bias - q.bias).abs().max().item()
        if words or sc or bias:
            bad.append(f"{n}: {words} of {p.packed.numel()} words, scale "
                       f"max |diff| {sc:.3g}, bias {bias:.3g}")
    if bad:
        raise AssertionError(f"cli: {what} differ from the uniform run's: "
                             + "; ".join(bad))
    log(f"cli: {what}: every packed word, scale and bias of layers "
        f"0-{CLI_DEPTH - 1} equal to the uniform run's, bit for bit")


def f32_rel(got, want, what, tol=None):
    """Relative L2 of f32 logits and their argmax agreement; raises if
    ``got`` is not finite or, with ``tol``, the L2 is over it."""
    got, want = got.float(), want.float()
    rel = ((got - want).norm() / want.norm()).item()
    if not torch.isfinite(got).all() or (tol is not None
                                         and not rel <= tol):
        raise AssertionError(f"{what}: relative L2 {rel:.4g} over {tol}")
    return rel, (got.argmax(-1) == want.argmax(-1)).float().mean().item()


def check_f32_logits(dev, cfg, engine, comps, what):
    """The Engine's f32 checkpoint (every linear K8f) against the plain
    versions on the card (use_kernel=False: the plain K8f, attention and
    KV write, TF32 off): the prefill logits of 4 of the served 256-token
    prompts and one decode step's (batch 8, from a clone of the Engine's
    int8 cache, at the last completion position), held to a relative L2
    of 1e-5 through layer 1 (f32 sums in another order; the prefill over
    an f32 cache, where no int8 rounding can flip) and measured through
    all layers (the prefill over the served int8 cache). Returns
    metrics."""
    params = engine.params
    rows = torch.as_tensor(np.stack([c.tokens[:256] for c in comps[:4]]),
                           dtype=torch.int64, device=dev)
    toks = (rows, 4)
    got, want = (prefill_logits(dev, cfg, params, toks, 1, k, torch.float32)
                 for k in (True, False))
    pre1, _ = f32_rel(got, want, f"{what} prefill logits through layer 1",
                      1e-5)
    got, want = (prefill_logits(dev, cfg, params, toks, cfg.n_layers, k)
                 for k in (True, False))
    pre_full, pre_agree = f32_rel(got, want, f"{what} prefill logits")
    del got, want
    tok = last_tokens(comps, dev)
    pos = max(len(c.tokens) for c in comps) - 1
    one = dataclasses.replace(cfg, n_layers=1)
    one_p = dict(params, layers=params["layers"][:1])
    got, want = (decode_step(one, one_p, tok, {k: v.clone() for k, v in
                                               engine.cache.items()},
                             pos, use_kernel=k)[0] for k in (True, False))
    dec1, _ = f32_rel(got, want, f"{what} decode logits through layer 1",
                      1e-5)
    dec_full, dec_agree = check_decode(cfg, params, engine.cache, tok, pos,
                                       f"{what} ", hold=False)
    log(f"{what}: kernels vs plain versions on the card, relative L2 "
        f"through layer 1: prefill {pre1:.3g}, decode {dec1:.3g} (<= 1e-5); "
        f"through {cfg.n_layers} layers (measured): prefill {pre_full:.3g} "
        f"(argmax agreement {pre_agree:.4f}), decode {dec_full:.3g} "
        f"({dec_agree:.4f})")
    return dict(prefill_layer1_rel_l2=pre1, decode_layer1_rel_l2=dec1,
                prefill_full_rel_l2=pre_full, prefill_full_agree=pre_agree,
                decode_full_rel_l2=dec_full, decode_full_agree=dec_agree)


def serve_cli_runs(dev, ckpt, model, cfg, card, what, kern=None):
    """``serve_cli.main`` on the checkpoint, slot and ``--paged``, int8
    KV, 8 random 256-token prompts, 32 new tokens, cold run then steady
    run: the launches of both through the replay accounting (K3 or K5 one
    a layer a decode step; K4 and K10 one a layer a prefill group; with
    ``kern``, K8f, 6 a layer a step and a prefill group; nothing else at
    f32, and ``dequant_matmul_ref`` never for a 'plane' linear), the same
    greedy tokens cold and steady, and slot and paged; with ``kern``, the
    slot run's logits as check_f32_logits holds them. Returns metrics."""
    L, m, tokens = cfg.n_layers, {}, {}
    lin = {kern: 6 * L} if kern else {}
    for paged in (False, True):
        mode = "paged" if paged else "slot"
        kernels.reset_launch_counts()
        prefills = [0.0, 0]
        with timed(engine_mod, "prefill", prefills), plane_on_kernels():
            res = serve_cli.main([ckpt, "--model", model, *SERVE_ARGS]
                                 + (["--paged"] if paged else []))
        launches = {k: n for k, n in counts().items() if n}
        attn_kernel = "K5" if paged else "K3"
        steps = check_replays(res["engine"], launches,
                              {attn_kernel: L, **lin}, {"K10": L, **lin},
                              prefills[1], f"cli serve {what} {mode}")
        if launches.get("K4") != L * prefills[1] or set(launches) != {
                attn_kernel, "K4", "K10", *lin}:
            raise AssertionError(f"cli serve {what} {mode}: launched "
                                 f"{launches} in {prefills[1]} prefill "
                                 f"groups")
        cold = [c.new_tokens.tolist() for c in res["cold"]]
        if [c.new_tokens.tolist() for c in res["steady"]] != cold or any(
                len(t) != 32 for t in cold):
            raise AssertionError(f"cli serve {what} {mode}: the steady run's "
                                 f"greedy tokens differ from the cold run's")
        tokens[mode] = cold
        m[mode] = dict(cold_s=res["cold_s"], steady_s=res["steady_s"],
                       cold_tokens_per_s=res["cold_tokens_per_s"],
                       steady_tokens_per_s=res["steady_tokens_per_s"],
                       prefill_groups=prefills[1], decode_steps=steps,
                       launches=launches)
        log(f"cli: serve_cli {what} {mode} (f32 OPT-1.3B, {L} layers, int8 "
            f"KV, 8 x 256-token prompts, 32 new tokens): cold "
            f"{res['cold_s']:.3f} s ({res['cold_tokens_per_s']:.1f} "
            f"tokens/s), steady {res['steady_s']:.3f} s "
            f"({res['steady_tokens_per_s']:.1f} tokens/s); cold and steady "
            f"greedy tokens equal; launches {launches} ({prefills[1]} "
            f"prefill groups, {steps} decode steps) ({card})")
        if kern and not paged:
            m["logits"] = check_f32_logits(dev, cfg, res["engine"],
                                           res["steady"],
                                           f"cli serve {what}")
        del res
    if tokens["paged"] != tokens["slot"]:
        raise AssertionError(f"cli serve {what}: the paged run's tokens "
                             f"differ from the slot run's")
    log(f"cli: serve_cli {what} paged and slot: the same greedy tokens")
    return m


def serve_bf16(dev, ckpt, card):
    """The uniform checkpoint (CLI_DEPTH layers) on the main path's bf16
    route: loaded onto bf16 OPT-1.3B of that depth (the dense leaves in
    bf16), q|k|v fused, the head packed int8, served through the slot
    Engine as ``serve`` serves the int4 model (K1, K2, K3, K4, K10;
    prefill logits, kernels vs plain versions, relative L2 <= 2^-6).
    Returns metrics."""
    cfg = dataclasses.replace(opt_1b3(dtype=torch.bfloat16),
                              n_layers=CLI_DEPTH)
    params, _ = load_packed_params(ckpt, cfg=cfg, device=dev)

    def bf16(tree):
        if isinstance(tree, dict):
            return {k: bf16(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [bf16(v) for v in tree]
        if isinstance(tree, torch.Tensor):
            return tree.to(torch.bfloat16)
        return tree

    params = pack_lm_head(cfg, tr.fuse_qkv_params(cfg, bf16(params)),
                          nbits=8)
    _, served, _, engine, _ = serve(dev, cfg, card, "cli_bf16", params, K1,
                                    make_prompts(cfg), NEW_TOKENS)
    del engine
    return served


def run_k9f_perplexity(dev, ckpt, cfg, card):
    """K9f on a path: the uniform checkpoint's indices repacked as 'plane'
    (uniform codebook: every linear K9f at f32), scored by ``perplexity``
    on 2 batches of 2 x 256 synthetic tokens (6 K9f and one K4 a layer a
    batch; ``dequant_matmul_ref`` never for a 'plane' linear), within 1e-5
    relative of the same weights' 'pair' perplexity on the plain route
    (the same function: the kernel folds over C - 1.5, the plain route
    multiplies by the dequantized weight). Returns metrics."""
    L = cfg.n_layers
    params, _ = load_packed_params(ckpt, cfg=cfg, device=dev)
    plane = repack(params, "plane", "pair")
    batches = list(chunk_tokens(synthetic_stream(cfg.vocab_size, 1024, 0),
                                256, 2))
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with plane_on_kernels():
        got = perplexity(cfg, plane, batches, device=dev)
    torch.cuda.synchronize()
    k9f_s = time.perf_counter() - t0
    launches = {k: n for k, n in counts().items() if n}
    want_l = {"K9f": 6 * L * len(batches), "K4": L * len(batches)}
    if launches != want_l:
        raise AssertionError(f"cli K9f perplexity: launched {launches}, not "
                             f"{want_l}")
    t0 = time.perf_counter()
    want = perplexity(cfg, params, batches, device=dev)
    torch.cuda.synchronize()
    pair_s = time.perf_counter() - t0
    rel = abs(got - want) / want
    if not (math.isfinite(got) and rel <= 1e-5):
        raise AssertionError(f"cli K9f perplexity {got} vs the pair plain "
                             f"route's {want}: {rel:.3g} apart")
    log(f"cli: the uniform checkpoint repacked as 'plane' ({L} layers, "
        f"f32): perplexity on K9f {got:.6f} in {k9f_s:.3f} s, launches "
        f"{launches}; the 'pair' weights on the plain route {want:.6f} in "
        f"{pair_s:.3f} s; {rel:.3g} apart (<= 1e-5) ({card})")
    return dict(ppl_k9f=got, ppl_pair_plain=want, rel=rel, seconds=k9f_s,
                pair_plain_s=pair_s, launches=launches)


def run_cli(dev, card):
    """The user's two commands on the card, at OPT-1.3B's full width
    (random weights from seed 0, nothing downloaded): an HF-layout
    checkpoint written as two F16 safetensors shards and read back; the
    quantize command on it with ``--codebook nf4`` at full depth (every
    linear NF4 'plane': the eval on K8f) and the serve command on its
    checkpoint, slot and paged; ``--codebook lloyd`` at CLI_DEPTH; the
    uniform run (int4 'pair', the plain route at f32) at CLI_DEPTH, served
    by the serve command and on the bf16 main path, its indices repacked
    as 'plane' and scored on K9f; and the spill and background-drain
    branches at CLI_DEPTH, their packed words held to the uniform run's.
    Returns (the phase's metrics, K8f's and K9f's launches on the
    path)."""
    m = {}
    cfg = opt_1b3()
    start = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="cli_") as tmp:
        hf_dir = os.path.join(tmp, "hf")
        os.makedirs(hf_dir)
        t0 = time.perf_counter()
        init = tr.init_params(cfg, seed=0, device=dev)
        torch.cuda.synchronize()
        m["init_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        sd = hf_opt_state_dict(init, cfg.n_layers)
        m["hf_bytes"] = write_hf_checkpoint(hf_dir, sd)
        del sd
        m["hf_write_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        params = load_hf_checkpoint(cfg, "opt-1.3b", hf_dir, device=dev)
        torch.cuda.synchronize()
        m["hf_load_s"] = time.perf_counter() - t0
        want, got = dict(leaves(init)), dict(leaves(params))
        if set(got) != set(want):
            raise AssertionError(f"cli: the HF round trip's tree differs: "
                                 f"{sorted(set(got) ^ set(want))}")
        for path, w in want.items():
            if not torch.equal(got[path], w.half().float()):
                raise AssertionError(f"cli: the HF round trip's {path} is not "
                                     f"the init weights rounded to f16")
        del init, want, got
        log(f"cli: HF checkpoint of OPT-1.3B (seed 0, init_params "
            f"{m['init_s']:.1f} s; facebook/opt-1.3b's keys, F16) in 2 "
            f"safetensors shards, {m['hf_bytes'] / 1e9:.3f} GB, written in "
            f"{m['hf_write_s']:.1f} s; load_hf_checkpoint "
            f"{m['hf_load_s']:.1f} s: every leaf the init weights rounded "
            f"to f16, bit for bit ({card})")
        m.update(cli_calibrations(cfg, params, card))
        p4_bytes = tree_bytes(dict(params,
                                   layers=params["layers"][:CLI_DEPTH]))
        del params
        torch.cuda.empty_cache()
        tok = ["--tokens", cli_shard(tmp, cfg, m, card)]

        # NF4 at full depth: the slice's path, every linear K8f.
        nf4 = os.path.join(tmp, "nf4")
        m["nf4"], _ = run_quantize_cli(nf4, "opt-1.3b", hf_dir, cfg,
                                       "NF4 'plane'", card,
                                       ["--codebook", "nf4", *tok], "K8f")
        path = {"K8f": sum(n.get("K8f", 0) for n in
                           m["nf4"]["eval_launches"].values())}
        torch.cuda.empty_cache()
        m["nf4_serve"] = serve_cli_runs(dev, nf4, "opt-1.3b", cfg, card,
                                        "NF4", "K8f")
        torch.cuda.empty_cache()

        # The CLI_DEPTH-layer runs, from a name of OPT-1.3B at that depth.
        name = f"opt-1.3b-{CLI_DEPTH}l"
        cfg4 = dataclasses.replace(cfg, n_layers=CLI_DEPTH)
        zoo.ZOO[name] = lambda **kw: dataclasses.replace(
            opt_1b3(**kw), n_layers=CLI_DEPTH)
        try:
            m["lloyd"], _ = run_quantize_cli(
                os.path.join(tmp, "lloyd"), name, hf_dir, cfg4,
                "lloyd 'plane'", card, ["--codebook", "lloyd", *tok], "K8f")
            torch.cuda.empty_cache()
            uni = os.path.join(tmp, "uniform")
            m["quantize"], uni_words = run_quantize_cli(
                uni, name, hf_dir, cfg4, "int4 'pair'", card, tok)
            torch.cuda.empty_cache()
            m["serve"] = serve_cli_runs(dev, uni, name, cfg4, card,
                                        "uniform")
            torch.cuda.empty_cache()
            m["bf16"] = serve_bf16(dev, uni, card)
            torch.cuda.empty_cache()
            m["k9f"] = run_k9f_perplexity(dev, uni, cfg4, card)
            path["K9f"] = m["k9f"]["launches"]["K9f"]
            torch.cuda.empty_cache()

            # The spill and drain branches, from limits computed with the
            # CLI's own estimates.
            s_est = est_stats_bytes(cfg4)
            entries = [(n, k, 4 * (k * k + k + 1)) for n, k in (
                (n, cfg.d_ff if n.endswith("fc2") else cfg.d_model)
                for n in tr.layer_names(cfg4))]
            sim_peak = offload_plan(entries, p4_bytes, math.inf,
                                    "never")["peak"]
            limits = {"spill": p4_bytes + s_est + SPILL_HEADROOM / 2,
                      "drain": sim_peak}
            plan = offload_plan(entries, p4_bytes, limits["drain"], "auto")
            if spill_needed(p4_bytes, s_est, limits["drain"]) or (
                    plan["action"] != "shed"):
                raise AssertionError(f"cli: the drain limit "
                                     f"{limits['drain']} gives no shed "
                                     f"plan: {plan}")
            for branch in ("spill", "drain"):
                out = os.path.join(tmp, branch)
                res, calib, _, peak, secs = quantize_cli(
                    out, name, hf_dir, tok, limit=limits[branch])
                check_cli_reports(res, cfg4, f"{branch} run")
                want_k4 = {"K4": CLI_DEPTH * CALIB_SAMPLES // CALIB_BATCH}
                if calib != want_k4:
                    raise AssertionError(f"cli {branch}: calibration "
                                         f"launched {calib}")
                if branch == "spill":
                    ok = res["spill"]
                else:
                    ok = (not res["spill"] and res["offload"] == "shed"
                          and res["shed"] == plan["shed"])
                if not ok:
                    raise AssertionError(
                        f"cli {branch}: spill {res['spill']}, offload "
                        f"{res['offload']}, shed {res['shed']}")
                same_words(packed_linears(out, cfg4), uni_words,
                           f"the {branch} run's layers")
                m[branch] = dict(limit=limits[branch], seconds=secs,
                                 peak_bytes=peak, timer=res["timer"],
                                 shed=res["shed"])
                log(f"cli: {branch} run ({CLI_DEPTH} layers, "
                    f"QUANT_HBM_LIMIT {limits[branch] / 1e9:.3f} GB): "
                    f"{secs:.1f} s; spill {res['spill']}, offload "
                    f"{res['offload']} ({len(res['shed'])} entries shed); "
                    f"sections " + json.dumps(
                        {k: v["total_s"] for k, v in res["timer"].items()})
                    + f"; no statistics left after the solves; peak device "
                    f"memory {peak / 1e9:.3f} GB ({card})")
                del res
        finally:
            del zoo.ZOO[name]
    m["phase_s"] = time.perf_counter() - start
    log(f"cli: the phase took {m['phase_s']:.1f} s ({card})")
    return m, path


# ---- the reference's ablation CLIs -----------------------------------------

# The headers of the JAX package's CLIs (tests/test_experiments.py),
# written out: the scaling CLI with every --run-* flag.
BITS_LABELS = (1, 1.5, 2, 2.3, 2.8, 3, 3.2, 3.9, 4, 5)
ABLATION_HEADERS = {
    "compare": "Data\tStandard\tCorrection\tScaling\tSleekitLight\t"
               "SleekitHeavy",
    "scaling": "Data\tMSE\tMax\tDiag\tDiag1\tDiag3\tDiag10\tHessian\t"
               "OBQAware",
    "correction": "Data\tScaling\tGPTQ\tGPTQ+BiasCorrection\t"
                  "GPTQWithBiasCorrection",
    "ordering": "Data\tScaling\tDiag\tDiagErr\tDiagSqErr",
    "dampening": "Data\tScaling\tDamp0.001\tDamp0.003\tDamp0.01\t"
                 "Damp0.03\tDamp0.1\tDamp0.3\tDamp1.0",
    "local_search": "Data\tScaling\tGPTQ\tGPTQ+LS10\tGPTQ+LS100",
    "bits": "Data" + "".join(f"\tStandard{b}-bit" for b in BITS_LABELS)
            + "".join(f"\tSleekitLight{b}-bit" for b in BITS_LABELS),
}
GRID10 = ["--grid-size", "10"]
ABLATIONS = (
    (compare, GRID10), (bits, ["--grid-size", "5"]),
    (scaling, GRID10 + ["--run-max", "--run-diag", "--run-diag1",
                        "--run-diag3", "--run-diag10", "--run-hessian",
                        "--run-obq-aware"]),
    (correction, GRID10), (ordering, GRID10), (dampening, GRID10),
    (local_search, GRID10))
# dump_stats's model: OPT-125m at full width and depth, on the JAX CLI's
# defaults (8 x 128 tokens, batch 2, seed 0).
ABLATION_MODEL = "opt-125m"
# The analysis CLIs leave out layer 0's fc2: its 3072-wide Hessian is most
# of their solves' work, and the quantize and CLI phases solve its shape.
ABLATION_SKIP = ("layers_0_fc2",)


def quiet(main, argv):
    """(stdout, seconds) of a CLI's ``main(argv)`` on the card."""
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        main(argv)
    torch.cuda.synchronize()
    return buf.getvalue(), time.perf_counter() - t0


def run_ablation(card):
    """The reference's ablation CLIs on the card: ``dump_stats`` writes
    OPT-125m's 72 linears (random weights from seed 0, its calibration on
    the card; the launches it makes are counted) into the temporary
    directory, every Hessian finite; then each analysis CLI runs over
    layer 0's linears but ABLATION_SKIP (a root holding only them),
    ``bits`` at grid 5 and the others at grid 10, ``scaling`` with every
    ``--run-*`` flag: the JAX CLIs' headers, the five layer names, every
    value finite, GPTQ+LS100 <= 1.001 x GPTQ, the 5-bit standard error
    below the 1-bit one; ``distribution --save-data`` writes every weight
    of the five;
    ``results`` on compare's table names SleekitHeavy. Returns each CLI's
    seconds, dump_stats's launches and bytes."""
    m = {"seconds": {}}
    with tempfile.TemporaryDirectory(prefix="ablation_") as tmp:
        data = os.path.join(tmp, ABLATION_MODEL)
        kernels.reset_launch_counts()
        out, m["seconds"]["dump_stats"] = quiet(
            dump_stats.main, [data, "--model", ABLATION_MODEL])
        m["dump_stats_launches"] = {k: n for k, n in counts().items() if n}
        cfg = zoo.get_config(ABLATION_MODEL)
        names = sorted(n.replace(".", "_") for n in tr.layer_names(cfg))
        if sorted(os.listdir(data)) != names:
            raise AssertionError(f"ablation: dump_stats wrote "
                                 f"{len(os.listdir(data))} layer dirs, not "
                                 f"{len(names)}")
        nbytes = 0
        for name in names:
            path = os.path.join(data, name)
            files = sorted(os.listdir(path))
            if files != ["bias.npy", "hessian.npy", "mean.npy", "weight.npy"]:
                raise AssertionError(f"ablation: {name} holds {files}")
            nbytes += sum(os.path.getsize(os.path.join(path, f))
                          for f in files)
            if not np.isfinite(np.load(os.path.join(path,
                                                    "hessian.npy"))).all():
                raise AssertionError(f"ablation: {name}'s Hessian is not "
                                     f"finite")
        m["dump_stats_bytes"] = nbytes
        log(f"ablation: dump_stats {ABLATION_MODEL} ({cfg.n_layers} layers, "
            f"{len(names)} linears): {m['seconds']['dump_stats']:.1f} s, "
            f"{nbytes / 1e9:.3f} GB on disk, launches "
            f"{m['dump_stats_launches']} ({out.strip()}; {card})")

        root = os.path.join(tmp, "layer0")
        layer0 = [n for n in names if n.startswith("layers_0_")
                  and n not in ABLATION_SKIP]
        for name in layer0:
            os.makedirs(os.path.join(root, name))
            for f in os.listdir(os.path.join(data, name)):
                os.link(os.path.join(data, name, f),
                        os.path.join(root, name, f))
        tables = {}
        for cli, argv in ABLATIONS:
            what = cli.__name__.rsplit(".", 1)[-1]
            out, m["seconds"][what] = quiet(cli.main, [root] + argv)
            rows = [line.split("\t") for line in out.strip().split("\n")]
            header = "\t".join(rows[0])
            if header != ABLATION_HEADERS[what]:
                raise AssertionError(f"ablation: {what}'s header {header!r}")
            if [r[0] for r in rows[1:]] != layer0:
                raise AssertionError(f"ablation: {what}'s layers "
                                     f"{[r[0] for r in rows[1:]]}")
            for r in rows[1:]:
                vals = [float(v) for v in r[1:] if v != "mse"]
                if not all(math.isfinite(v) for v in vals):
                    raise AssertionError(f"ablation: {what} {r}")
                if what == "local_search" and not vals[2] <= 1.001 * vals[0]:
                    raise AssertionError(f"ablation: local search raised "
                                         f"{r[0]}'s error: {r}")
                if what == "bits" and not vals[9] < vals[0]:
                    raise AssertionError(f"ablation: {r[0]}'s 5-bit "
                                         f"error is not below its 1-bit one")
            tables[what] = out
            log(f"ablation: {what} over layer 0's {len(layer0)} linears: "
                f"{m['seconds'][what]:.1f} s ({card})")
            for line in out.strip().split("\n"):
                log(f"ablation:   {line}")
        path = os.path.join(tmp, "values.npy")
        out, m["seconds"]["distribution"] = quiet(
            distribution.main, [root, "--scaling", "mse", "--save-data",
                                path] + GRID10)
        n_weights = sum(np.load(os.path.join(root, n, "weight.npy")).size
                        for n in layer0)
        values = np.load(path)
        if values.shape != (n_weights,) or not np.isfinite(values).all():
            raise AssertionError(f"ablation: distribution wrote "
                                 f"{values.shape} values")
        tsv = os.path.join(tmp, "compare_3b.csv")
        with open(tsv, "w") as f:
            f.write(tables["compare"])
        out, m["seconds"]["results"] = quiet(results.main, [tsv])
        if "SleekitHeavy" not in out:
            raise AssertionError(f"ablation: results printed {out!r}")
        log(f"ablation: distribution {m['seconds']['distribution']:.1f} s "
            f"({values.size} values), results "
            f"{m['seconds']['results']:.2f} s:")
        for line in out.strip().split("\n"):
            log(f"ablation:   {line}")
    m["total_s"] = sum(m["seconds"].values())
    log(f"ablation: the phase's CLIs took {m['total_s']:.1f} s ({card})")
    return m


# ---- tensor-parallel serving (parallel/) -----------------------------------


# The two-rank phase: 4 prompts of 256 tokens (the 256-bucket group's
# shape), then TP_STEPS greedy decode steps; both ranks on one card over
# gloo (NCCL refuses two ranks on one device).
TP_BATCH, TP_PROMPT, TP_STEPS = 4, 256, 32
TP_DEPTH = 24
TP_TIMEOUT_S = 600


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def tp_counts(group):
    """The kernels' launches (those launched) and the group's collectives."""
    return {**{k: n for k, n in counts().items() if n},
            **{k: n for k, n in group.counts.items() if n}}


def tp_expected(cfg, steps, prefill=False, gathers=1):
    """One TP run's launches and collectives: a layer's six K1 (q, k, v, o,
    fc1, fc2) and two all-reduces; K3 a layer a decode step, K4 and K10 a
    layer a prefill; K2 and the logits' all-gather once a step (an
    all-gather only over more than one rank)."""
    L = cfg.n_layers
    want = {"K1": 6 * L * steps, "K2": steps, "all_reduce": 2 * L * steps}
    if prefill:
        want.update(K4=L, K10=L)
    else:
        want["K3"] = L * steps
    if gathers:
        want["all_gather"] = steps
    return want


def hold_counts(got, want, what):
    if got != want:
        raise AssertionError(f"{what}: launches and collectives {got}, "
                             f"expected {want}")


def run_tp_one_rank(dev, cfg, card, tmp):
    """``tp_decode_step`` over a world-1 NCCL group on this card at
    OPT-1.3B's full width and depth (int4 'pair', unfused, int8 head, int8
    KV with bf16 scales, batch 8 from a 256-token prefill): its logits
    against the single-device kernel step's on the same unfused params
    (relative L2 <= 2^-6); the step captured in a CUDA graph with its 48
    all-reduces, the replay's logits and cache equal to the eager step's
    bit for bit; then 32 greedy steps of ``DecodeGraph`` over the mesh,
    graph and eager: the same tokens, the launches and all-reduces counted
    from the replays, the graph loop timed beside the single-device
    unfused one."""
    init_process_group(init_method=f"file://{tmp}/world1", rank=0,
                       world_size=1, device=dev)
    try:
        mesh = make_mesh(model=1)
        group = mesh.group
        params, _ = random_packed_params(cfg, 0, device=dev)
        params = pack_lm_head(cfg, params)
        local = shard_params(cfg, params, mesh)
        toks = torch.from_numpy(np.random.default_rng(2).integers(
            0, cfg.vocab_size, (8, 256))).to(dev)
        cache = init_kv_cache(cfg, 8, 512, torch.int8, device=dev)
        logits, _ = prefill(cfg, params, toks, cache)
        nxt = logits[:, -1].argmax(-1)[:, None]
        pos = torch.full((8,), 256, dtype=torch.int32, device=dev)

        def clone():
            return {k: v.clone() for k, v in cache.items()}

        ref, _ = decode_step(cfg, params, nxt, clone(), pos)
        eager_cache = clone()
        eager, _ = tp_decode_step(cfg, local, nxt, eager_cache, pos, mesh)
        rel, agree = rel_l2(eager.float(), ref.float(),
                            "tp world 1 vs single-device decode logits")
        graph_cache, g = clone(), torch.cuda.CUDAGraph()
        kernels.reset_launch_counts()
        group.reset_counts()
        with kernels.captured_launches() as calls, torch.cuda.graph(
                g, capture_error_mode="thread_local"):
            out, _ = tp_decode_step(cfg, local, nxt, graph_cache, pos, mesh)
        captured = {**{k.name: n for k, n in calls.items()},
                    **{k: n for k, n in group.counts.items() if n}}
        hold_counts(captured, tp_expected(cfg, 1, gathers=0),
                    "tp world 1: the captured step")
        g.replay()
        torch.cuda.synchronize()
        if not torch.equal(out, eager) or not all(
                torch.equal(graph_cache[k], eager_cache[k])
                for k in cache):
            raise AssertionError("tp world 1: the replayed step's logits or "
                                 "cache differ from the eager step's")
        del g, out
        log(f"tp world 1 (NCCL): decode logits vs the single-device kernel "
            f"step (unfused): relative L2 {rel:.4g} (<= 2^-6), max |err| "
            f"{(eager.float() - ref.float()).abs().max().item():.4g}, "
            f"argmax agreement {agree:.4f}; the step captured in a CUDA "
            f"graph with {captured['all_reduce']} all-reduces: replay = "
            f"eager, bit for bit")

        m, tokens = {"tp1_rel_l2": rel, "tp1_argmax_agreement": agree}, {}
        for what, graphs, mesh_ in (("tp", False, mesh), ("tp", True, mesh),
                                    ("single", True, None)):
            run = DecodeGraph(cfg, local, 8, TP_STEPS, device=dev,
                              graphs=graphs, mesh=mesh_)
            c = clone()
            for _ in range(2):      # the first call captures
                run.last.copy_(nxt[:, 0])
                run.pos.copy_(pos)
                for k in c:
                    c[k].copy_(cache[k])
                kernels.reset_launch_counts()
                group.reset_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                run.run(c, TP_STEPS)
                torch.cuda.synchronize()
                step_ms = (time.perf_counter() - t0) / TP_STEPS * 1e3
            route = f"{what}_{'graph' if graphs else 'eager'}"
            m[f"{route}_ms_per_step"] = step_ms
            tokens[route] = run.tokens.clone()
            if mesh_ is not None:
                want = tp_expected(cfg, TP_STEPS, gathers=0)
                hold_counts(tp_counts(group), want, f"tp world 1 {route}")
        if not torch.equal(tokens["tp_graph"], tokens["tp_eager"]):
            raise AssertionError("tp world 1: the graph route's tokens differ "
                                 "from the eager route's")
        m["tp1_tokens_equal_single"] = bool(torch.equal(
            tokens["tp_graph"], tokens["single_graph"]))
        m["tp1_launches_graph_run"] = tp_expected(cfg, TP_STEPS, gathers=0)
        log(f"tp world 1: batch 8, ctx 256-{256 + TP_STEPS}, {TP_STEPS} "
            f"steps: graph loop {m['tp_graph_ms_per_step']:.3f} ms/step "
            f"(eager {m['tp_eager_ms_per_step']:.3f}), the single-device "
            f"unfused graph loop {m['single_graph_ms_per_step']:.3f} ms/step; "
            f"graph tokens = eager tokens, = single-device tokens: "
            f"{m['tp1_tokens_equal_single']}; launches and all-reduces "
            f"counted from the replays: {m['tp1_launches_graph_run']} ({card})")
        return m
    finally:
        torch.distributed.destroy_process_group()


def tp_rank(rank, init, cfg, device, out):
    """One of the two-rank phase's ranks (a spawned process, both on
    ``device``, gloo): builds the model ``cfg`` (seed 0), its shard, prefills the 4 x 256
    prompts and decodes TP_STEPS greedy steps eagerly, counting launches
    and collectives; rank 0 then runs the single-device kernels on the
    unsplit params, teacher-forced on the same tokens, and measures the
    logits' relative L2. Sends (rank, ok, result or traceback)."""
    try:
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
        init_process_group(backend="gloo", init_method=init, rank=rank,
                           world_size=2, device=dev)
        mesh = make_mesh(model=2, device=dev)
        group = mesh.group
        params, _ = random_packed_params(cfg, 0, device=dev)
        params = pack_lm_head(cfg, params)
        local = shard_params(cfg, prepare_params_for_tp(cfg, params, 2),
                             mesh)
        toks = torch.from_numpy(np.random.default_rng(3).integers(
            0, cfg.vocab_size, (TP_BATCH, TP_PROMPT))).to(dev)
        cache = init_kv_cache(tp_local_cfg(cfg, 2), TP_BATCH, 512,
                              torch.int8, device=dev)
        res = {}
        kernels.reset_launch_counts()
        group.reset_counts()
        sync(dev)
        t0 = time.perf_counter()
        pre, _ = tp_prefill(cfg, local, toks, cache, mesh)
        sync(dev)
        res["prefill_s"] = time.perf_counter() - t0
        res["prefill_counts"] = tp_counts(group)
        fed, logits = [pre[:, -1].argmax(-1)[:, None]], []
        kernels.reset_launch_counts()
        group.reset_counts()
        t0 = time.perf_counter()
        for i in range(TP_STEPS):
            step, _ = tp_decode_step(cfg, local, fed[-1], cache,
                                     TP_PROMPT + i, mesh)
            logits.append(step.float())
            fed.append(step.argmax(-1)[:, None])
        sync(dev)
        res["decode_ms_per_step"] = (time.perf_counter() - t0) / TP_STEPS * 1e3
        res["decode_counts"] = tp_counts(group)
        res["tokens"] = torch.cat(fed[1:], dim=1).cpu().numpy()
        if rank == 0:
            ref_cache = init_kv_cache(cfg, TP_BATCH, 512, torch.int8,
                                      device=dev)
            ref, _ = prefill(cfg, params, toks, ref_cache)
            res["prefill_rel_l2"], res["prefill_argmax_agreement"] = rel_l2(
                pre.float(), ref.float(), "tp2 prefill logits", hold=False)
            rels, agree = [], []
            for i in range(TP_STEPS):
                ref, _ = decode_step(cfg, params, fed[i], ref_cache,
                                     TP_PROMPT + i)
                r, a = rel_l2(logits[i], ref.float(), "tp2 decode logits",
                              hold=False)
                rels.append(r)
                agree.append(a)
            res["decode_rel_l2_max"] = max(rels)
            res["decode_argmax_agreement"] = float(np.mean(agree))
        out.put((rank, True, res))
    except Exception:  # sent to the parent, which fails on it
        out.put((rank, False, traceback.format_exc()))
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def run_tp_two_ranks(cfg, card, tmp, device="cuda:0"):
    """Two spawned ranks on this one card over gloo serve ``cfg`` (OPT-1.3B
    at full width, TP_DEPTH layers) split by ``prepare_params_for_tp(..., 2)``:
    ``tp_prefill`` of 4 x 256 prompts, then 32 eager greedy decode steps.
    Both ranks emit the same tokens; the logits are within a relative L2
    of 2^-6 of the single-device kernels' (teacher-forced on the same
    tokens); each rank launches 6 K1, 1 K3 (prefill: K4 and K10) and 2
    all-reduces a layer, and 1 K2 and 1 all-gather a step. Its times
    measure two ranks sharing one card through the host's gloo, not
    tensor parallelism's speed."""
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    init = f"file://{tmp}/world2"
    procs = [ctx.Process(target=tp_rank, args=(r, init, cfg, device, out))
             for r in range(2)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    got = {}
    try:
        while len(got) < len(procs):
            try:
                rank, ok, res = out.get(timeout=1.0)
            except queue.Empty:
                dead = [p.exitcode for p in procs if p.exitcode]
                if dead or time.perf_counter() - t0 > TP_TIMEOUT_S:
                    raise AssertionError(f"tp: ranks exited ({dead}) or "
                                         f"timed out without a result")
                continue
            if not ok:
                raise AssertionError(f"tp rank {rank} failed:\n{res}")
            got[rank] = res
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    wall = time.perf_counter() - t0
    for rank, res in got.items():
        hold_counts(res["prefill_counts"], tp_expected(cfg, 1, prefill=True),
                    f"tp2 rank {rank} prefill")
        hold_counts(res["decode_counts"], tp_expected(cfg, TP_STEPS),
                    f"tp2 rank {rank} decode")
    if not np.array_equal(got[0]["tokens"], got[1]["tokens"]):
        raise AssertionError("tp2: the ranks' tokens differ")
    r0 = got[0]
    for key in ("prefill_rel_l2", "decode_rel_l2_max"):
        if not r0[key] <= 2 ** -6:
            raise AssertionError(f"tp2 {key} {r0[key]:.4g} over 2^-6")
    m = {f"tp2_{k}": v for k, v in r0.items() if k != "tokens"}
    m["tp2_phase_s"] = wall
    log(f"tp two ranks (gloo, one card): OPT-1.3B at {cfg.n_layers} layers, "
        f"prefill 4 x 256 then {TP_STEPS} greedy steps; logits vs the "
        f"single-device kernels: prefill relative L2 "
        f"{r0['prefill_rel_l2']:.4g}, decode max {r0['decode_rel_l2_max']:.4g}"
        f" (<= 2^-6), argmax agreement {r0['decode_argmax_agreement']:.4f}; "
        f"both ranks' tokens equal; launches and collectives a rank: "
        f"prefill {r0['prefill_counts']}, decode {r0['decode_counts']}; "
        f"prefill {r0['prefill_s']:.3f} s, decode "
        f"{r0['decode_ms_per_step']:.2f} ms/step eager (two ranks sharing "
        f"the card through host gloo: not TP's speed); the phase {wall:.1f}"
        f" s ({card})")
    return m


def run_tp(dev, cfg, card):
    """The tensor-parallel phase: the kernels at a rank's shapes, the
    world-1 NCCL step and graph, and the two-rank run. Returns (its
    metrics, the kernels' cases)."""
    start = time.perf_counter()
    g = torch.Generator().manual_seed(19)
    cases = {**check_linears(dev, cfg, ["K1"], tp=2),
             "K2": check_k2(dev, g, cfg, tp=2),
             "K3": check_k3(dev, g, cfg, tp=2)}
    with tempfile.TemporaryDirectory() as tmp:
        m = run_tp_one_rank(dev, cfg, card, tmp)
        torch.cuda.empty_cache()
        m.update(run_tp_two_ranks(
            dataclasses.replace(cfg, n_layers=TP_DEPTH), card, tmp))
    m["phase_s"] = time.perf_counter() - start
    log(f"tp: the phase took {m['phase_s']:.1f} s ({card})")
    return m, cases


# ---- the data axis (serve/router.py, data-parallel quantizer) -------------


# Phase 13's ranks: two gloo ranks on this one card (NCCL refuses two
# ranks on one device), a (data 2, model 1) mesh.
DP_TIMEOUT_S = 600
# calibrate(mesh=) against the single-process statistics of the same
# batches, as max |diff| over max |ref| of each Hessian and mean: each
# rank's forward takes 1 row of a batch where the single process takes
# 2, and cuBLAS may round a bf16 product of another M otherwise, so
# activations (and the statistics) differ by bf16 steps here and there;
# the merge itself is f32 (1e-7 on the CPU).
DP_STATS_RTOL = 2 ** -7
# The whole data-parallel pipeline (calibrate(mesh=), then the mesh solve)
# against the single process's batched route on its own statistics, by
# error only: the statistics' bf16 differences move a rounding here and
# there, which the sweep carries on, so codewords are not held (0.783
# equal at worst), but each layer's error and the summed error stay close
# (0.00272, layers.1.o, and 0.00022, the same in three runs on an H100);
# the gates leave 3.7x and 4.5x room above those readings, and a merge
# off by a rank's weight moves the errors by far more.
DP_PIPELINE_LAYER_RTOL, DP_PIPELINE_TOTAL_RTOL = 1e-2, 1e-3


def router_run(router, reqs):
    """Serve ``reqs`` through ``router`` from zeroed launch counts. Each
    replica's launches and prefills are counted around its own steps;
    the prefills of all replicas and every decode call are timed between
    synchronizations, as ``engine_run`` times one Engine's. Returns
    (completions, {replica: launches}, {replica: prefills}, metrics)."""
    kernels.reset_launch_counts()
    prefill_s, decode_s = [0.0, 0], [0.0, 0]
    launches = {rid: {} for rid in router.engines}
    prefills = dict.fromkeys(router.engines, 0)

    def attributed(rid):
        def wrap(inner):
            def step_auto():
                before, n = counts(), prefill_s[1]
                inner()
                for k, c in counts().items():
                    if c > before[k]:
                        launches[rid][k] = (launches[rid].get(k, 0) + c
                                            - before[k])
                prefills[rid] += prefill_s[1] - n
            return step_auto
        return wrap

    with contextlib.ExitStack() as stack:
        stack.enter_context(timed(engine_mod, "prefill", prefill_s))
        for rid, e in router.engines.items():
            stack.enter_context(timed(e, "_decode", decode_s))
            stack.enter_context(patched(e, "step_auto", attributed(rid)))
        t0 = time.perf_counter()
        comps = router.run(reqs)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
    new = sum(len(c.new_tokens) for c in comps)
    rest_s = run_s - prefill_s[0]
    m = dict(run_s=run_s, prefill_s=prefill_s[0], prefills=prefill_s[1],
             decode_s=rest_s, decode_calls_s=decode_s[0],
             decode_calls=decode_s[1], tokens_per_s=new / run_s,
             decode_tokens_per_s=(new - len(comps)) / rest_s)
    return comps, launches, prefills, m


def run_replicas(dev, cfg, card, single):
    """Two replicas on this one card in this process: a ``ReplicaRouter``
    over ``replica_meshes(2, devices=["cuda:0", "cuda:0"])`` serves phase
    3's model (full width and depth, int4 'pair', fused q|k|v, int8 head,
    int8 KV with bf16 scales) and its 8 prompts, 32 new tokens each, slot
    and paged, on the graph route: request i on replica i % 2; each
    replica's tokens those of a standalone Engine of the same geometry
    and seed fed its requests, bit for bit; each replica's launches
    replay-counted (96 K1, 1 K2 and 24 K3, paged K5, a step; K10 24 a
    prefill). ``single``: phase 3's metrics, printed beside. Returns
    (metrics, the slot run's tokens by request)."""
    params, _ = random_packed_params(cfg, seed=0, fuse_qkv=True,
                                     layout="pair", device=dev)
    params = pack_lm_head(cfg, params, nbits=8)
    prompts = make_prompts(cfg)
    L = cfg.n_layers
    m, tokens = {}, None
    for paged in (False, True):
        what = "replicas paged" if paged else "replicas"
        attn = "K5" if paged else "K3"
        kw = dict(max_slots=8, max_seq_len=512, cache_dtype=torch.int8,
                  use_kernel=True, paged=paged, page_size=PS)
        router = ReplicaRouter(cfg, params, replica_meshes(
            2, devices=["cuda:0", "cuda:0"]), **kw)
        comps, launches, prefills, rm = router_run(router, [
            Request(prompt=p, max_new_tokens=NEW_TOKENS) for p in prompts])
        owners = [router.owner(i) for i in range(len(prompts))]
        if owners != [i % 2 for i in range(len(prompts))]:
            raise AssertionError(f"{what}: requests went to {owners}")
        steps = {}
        for rid, e in router.engines.items():
            if not e.graphs or set(launches[rid]) != {"K1", "K2", attn,
                                                      "K4", "K10"}:
                raise AssertionError(f"{what}: replica {rid} launched "
                                     f"{launches[rid]} (graphs {e.graphs})")
            steps[rid] = check_replays(
                e, launches[rid], {"K1": 4 * L, "K2": 1, attn: L},
                {"K1": 4 * L, "K2": 1, "K10": L}, prefills[rid],
                f"{what} replica {rid}")
        check_completions(comps, prompts, cfg, what)
        for rep in (0, 1):
            alone = Engine(cfg, params, device=dev, **kw).run(
                [Request(prompt=p, max_new_tokens=NEW_TOKENS)
                 for p in prompts[rep::2]])
            same_tokens(comps[rep::2], [c.tokens for c in alone],
                        f"{what}: replica {rep} vs a standalone Engine fed "
                        f"requests {rep}::2")
        if not paged:
            tokens = [c.tokens for c in comps]
        key = what.replace(" ", "_")
        m.update({f"{key}_{k}": v for k, v in rm.items()})
        m[f"{key}_steps"] = steps
        log(f"{what}: 2 replicas on one card, {len(comps)} requests x "
            f"{NEW_TOKENS} tokens in {rm['run_s']:.3f} s "
            f"({rm['tokens_per_s']:.1f} tokens/s), prefills "
            f"{rm['prefill_s']:.3f} s ({rm['prefills']}), the rest "
            f"{rm['decode_s']:.3f} s ({rm['decode_tokens_per_s']:.1f} decode "
            f"tokens/s), decode steps by replica {steps}; phase 3's single "
            f"Engine {single['int4_engine_run_s']:.3f} s "
            f"({single['int4_engine_tokens_per_s']:.1f} tokens/s), prefills "
            f"{single['int4_engine_prefill_s']:.3f} s, the rest "
            f"{single['int4_engine_decode_s']:.3f} s ({card})")
        del router
    return m, tokens


def word_hashes(cfg, packed):
    return {n: hashlib.sha256(tr.get_linear_param(packed, n).packed.cpu()
                              .numpy().tobytes()).hexdigest()
            for n in tr.layer_names(cfg)}


def stats_distance(got, want):
    """calibrate(mesh=)'s statistics against the single process's: equal
    counts, and the largest max |diff| / max |ref| of the Hessians and of
    the means."""
    h = m = 0.0
    counts_equal = True
    for name, ref in want.items():
        st = got[name]
        counts_equal = counts_equal and float(st.count) == float(ref.count)
        h = max(h, ((st.hessian - ref.hessian).abs().max()
                    / ref.hessian.abs().max()).item())
        m = max(m, ((st.mean - ref.mean).abs().max()
                    / ref.mean.abs().max()).item())
    return counts_equal, h, m


def dp_rank(rank, init, cfg, device, tokens, out):
    """One of phase 13's two ranks (a spawned process on ``device``,
    gloo, a (data 2, model 1) mesh). Serves its replica of phase 3's
    model (``local_replica_mesh``, a router that holds only it) on the
    8 prompts; then, at the quantize phase's bf16 OPT-1.3B (QUANT_DEPTH
    layers), ``calibrate(mesh=)`` on its row of each batch and
    ``quantize_model(layer_parallel=True, pack=True, mesh=)``; rank 0 then
    measures the statistics against the single process's, and the packed
    model against the single process's batched route on the same
    statistics and on the single process's. Sends (rank, ok, result or
    traceback)."""
    try:
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
        init_process_group(backend="gloo", init_method=init, rank=rank,
                           world_size=2, device=dev)
        mesh = make_mesh(data=2, model=1, device=dev)
        sub = local_replica_mesh(1, device=dev)
        res = {"replica": sub.data_rank}
        params, _ = random_packed_params(cfg, seed=0, fuse_qkv=True,
                                         layout="pair", device=dev)
        params = pack_lm_head(cfg, params, nbits=8)
        router = ReplicaRouter(cfg, params, [sub],
                               replica_ids=[sub.data_rank], n_replicas=2,
                               max_slots=8, max_seq_len=512,
                               cache_dtype=torch.int8, use_kernel=True)
        groups = {"data": mesh.data_group, "world": mesh.world,
                  "model": sub.group}
        for g in groups.values():
            g.reset_counts()
        sync(dev)
        t0 = time.perf_counter()
        comps = router.run([Request(prompt=p, max_new_tokens=NEW_TOKENS)
                            for p in make_prompts(cfg)])
        sync(dev)
        res["serve_s"] = time.perf_counter() - t0
        res["graphs"] = router.engines[sub.data_rank].graphs
        res["ids"] = [c.request_id for c in comps]
        res["tokens_equal"] = all(np.array_equal(c.tokens,
                                                 tokens[c.request_id])
                                  for c in comps)
        res["serve_collectives"] = {k: dict(g.counts)
                                    for k, g in groups.items()}
        del router, params, comps
        torch.cuda.empty_cache()

        qcfg = dataclasses.replace(cfg, n_layers=QUANT_DEPTH)
        qparams = tr.init_params(qcfg, seed=0, device=dev)
        batches = calibration_batches(
            synthetic_stream(qcfg.vocab_size, CALIB_SAMPLES * CALIB_LEN,
                             seed=0), CALIB_SAMPLES, CALIB_LEN, CALIB_BATCH)
        kernels.reset_launch_counts()
        mesh.data_group.reset_counts()
        sync(dev)
        t0 = time.perf_counter()
        stats = calibrate(qcfg, qparams, batches, mesh=mesh)
        sync(dev)
        res["calibrate_s"] = time.perf_counter() - t0
        res["calibrate_launches"] = {k: n for k, n in counts().items() if n}
        res["calibrate_collectives"] = dict(mesh.data_group.counts)
        chunks = {}

        def record(inner):
            def batch(params, stats, group, *a):
                chunks.setdefault(shape_of(group[0]), []).append(len(group))
                return inner(params, stats, group, *a)
            return batch

        qc = preset_config("light", nbits=4)
        kernels.reset_launch_counts()
        mesh.world.reset_counts()
        torch.cuda.reset_peak_memory_stats(dev)
        sync(dev)
        t0 = time.perf_counter()
        with patched(quant_mod, "_solve_layer_batch", record):
            packed, reports = quantize_model(qcfg, qparams, stats, qc,
                                             pack=True, layer_parallel=True,
                                             mesh=mesh)
        sync(dev)
        res["quantize_s"] = time.perf_counter() - t0
        res["quantize_peak_bytes"] = torch.cuda.max_memory_allocated(dev)
        res["chunks"] = chunks
        res["quantize_launches"] = {k: n for k, n in counts().items() if n}
        res["quantize_collectives"] = dict(mesh.world.counts)
        res["words"] = word_hashes(qcfg, packed)
        res["errors"] = {r.name: r.error for r in reports}
        if rank == 0:
            single = calibrate(qcfg, qparams, batches)
            (res["stats_counts_equal"], res["stats_hessian_rel"],
             res["stats_mean_rel"]) = stats_distance(stats, single)
            for key, st in (("same", stats), ("single", single)):
                ref, ref_reports = quantize_model(
                    qcfg, qparams, st, qc, pack=True, layer_parallel=True)
                rels, shares, total_rel, equal = route_distance(
                    ref, ref_reports, packed, reports)
                res[key] = dict(error_rel=rels, codeword_share=shares,
                                total_error_rel=total_rel, words_equal=equal)
                del ref
        out.put((rank, True, res))
    except Exception:  # sent to the parent, which fails on it
        out.put((rank, False, traceback.format_exc()))
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def run_data_ranks(cfg, card, tmp, tokens, device="cuda:0"):
    """Two spawned gloo ranks sharing this card, ``make_mesh(data=2,
    model=1)``: each serves its replica (tokens equal to the one-process
    router's for its requests, no collective on the data axis or the
    world while serving); ``calibrate(mesh=)`` on the quantize phase's
    defaults (each rank 1 row of each batch of 2; 32 K4 launches a rank,
    three all-reduces an entry), its counts equal to the single
    process's and its Hessians and means within DP_STATS_RTOL; then the
    mesh solve (one all-reduce and four all-gathers a chunk, no kernel):
    both ranks' packed words equal, bit for bit, and held to the single
    process's batched route on the same statistics by the quantize
    phase's gates; against that route on the single process's statistics
    by error only, within DP_PIPELINE_LAYER_RTOL and DP_PIPELINE_TOTAL_RTOL
    (the statistics' bf16 differences move codewords). Returns
    metrics."""
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    init = f"file://{tmp}/data2"
    procs = [ctx.Process(target=dp_rank, args=(r, init, cfg, device,
                                                tokens, out))
             for r in range(2)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    got = {}
    try:
        while len(got) < len(procs):
            try:
                rank, ok, res = out.get(timeout=1.0)
            except queue.Empty:
                dead = [p.exitcode for p in procs if p.exitcode]
                if dead or time.perf_counter() - t0 > DP_TIMEOUT_S:
                    raise AssertionError(f"data axis: ranks exited ({dead}) "
                                         f"or timed out without a result")
                continue
            if not ok:
                raise AssertionError(f"data axis rank {rank} failed:\n{res}")
            got[rank] = res
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    wall = time.perf_counter() - t0
    n_entries = 6 * QUANT_DEPTH
    for rank, res in got.items():
        what = f"data axis rank {rank}"
        if res["ids"] != list(range(rank, len(tokens), 2)) or not (
                res["tokens_equal"] and res["graphs"]):
            raise AssertionError(f"{what}: served {res['ids']}, tokens "
                                 f"equal {res['tokens_equal']}, graphs "
                                 f"{res['graphs']}")
        if any(n for c in res["serve_collectives"].values()
               for n in c.values()):
            raise AssertionError(f"{what}: collectives while serving "
                                 f"{res['serve_collectives']}")
        want = {"K4": QUANT_DEPTH * CALIB_SAMPLES // CALIB_BATCH}
        if (res["calibrate_launches"] != want
                or res["calibrate_collectives"] != {
                    "all_reduce": 3 * n_entries, "all_gather": 0}):
            raise AssertionError(f"{what}: calibration launched "
                                 f"{res['calibrate_launches']}, collectives "
                                 f"{res['calibrate_collectives']}")
        n_chunks = sum(len(c) for c in res["chunks"].values())
        if res["quantize_launches"] or res["quantize_collectives"] != {
                "all_reduce": n_chunks, "all_gather": 4 * n_chunks} or sum(
                    map(sum, res["chunks"].values())) != n_entries:
            raise AssertionError(f"{what}: the mesh solve launched "
                                 f"{res['quantize_launches']}, collectives "
                                 f"{res['quantize_collectives']}, chunks "
                                 f"{res['chunks']}")
    if got[0]["words"] != got[1]["words"] or got[0]["errors"] != got[1][
            "errors"]:
        raise AssertionError("data axis: the ranks' packed words or errors "
                             "differ")
    r0 = got[0]
    m = {f"dp_rank{r}_{k}": v for r, res in got.items()
         for k, v in res.items() if k not in ("words", "errors", "ids")}
    m["dp_phase_s"] = wall
    for r, res in sorted(got.items()):
        log(f"data axis rank {r} (gloo, two ranks on one card): "
            f"served replica {res['replica']} (requests {res['ids']}) in "
            f"{res['serve_s']:.3f} s on the graph route, tokens equal to the "
            f"one-process router's, collectives while serving "
            f"{res['serve_collectives']}; calibrate(mesh=) "
            f"{res['calibrate_s']:.3f} s, launches "
            f"{res['calibrate_launches']}, collectives "
            f"{res['calibrate_collectives']}; the mesh solve "
            f"{res['quantize_s']:.3f} s, chunks " + json.dumps(res["chunks"])
            + f", collectives {res['quantize_collectives']}, peak "
            f"{res['quantize_peak_bytes'] / 1e9:.3f} GB allocated ({card})")
    same, single = r0["same"], r0["single"]
    log(f"data axis: calibrate(mesh=) vs the single process's statistics: "
        f"counts equal {r0['stats_counts_equal']}, Hessians within "
        f"{r0['stats_hessian_rel']:.3g} and means within "
        f"{r0['stats_mean_rel']:.3g} of their largest entry (<= "
        f"{DP_STATS_RTOL:g}); the mesh solve: both ranks' packed words "
        f"equal, bit for bit; against the single process's batched route "
        f"on the same statistics: summed error {same['total_error_rel']:.3g}"
        f" apart (<= {BATCHED_TOTAL_RTOL:g}), each layer's within "
        f"{max(same['error_rel'].values()):.3g} (<= {BATCHED_LAYER_RTOL:g}),"
        f" codewords equal {min(same['codeword_share'].values()):.5f} at "
        f"worst (>= {BATCHED_MIN_SHARE:g}), words all equal: "
        f"{same['words_equal']}; calibrate(mesh=) then the mesh solve "
        f"against the single process's batched route on its own statistics: "
        f"summed error {single['total_error_rel']:.3g} apart (<= "
        f"{DP_PIPELINE_TOTAL_RTOL:g}), each layer's within "
        f"{max(single['error_rel'].values()):.3g} (<= "
        f"{DP_PIPELINE_LAYER_RTOL:g}), codewords equal "
        f"{min(single['codeword_share'].values()):.5f} at worst (measured, "
        f"not held); the ranks' phase {wall:.1f} s ({card})")
    log("data axis: calibrate(mesh=) then the mesh solve vs the batched "
        "route on the single process's statistics by layer [error rel, "
        "codeword share] "
        + json.dumps({n: [round(single["error_rel"][n], 7),
                          round(single["codeword_share"][n], 5)]
                      for n in single["error_rel"]}))
    if not (r0["stats_counts_equal"]
            and r0["stats_hessian_rel"] <= DP_STATS_RTOL
            and r0["stats_mean_rel"] <= DP_STATS_RTOL):
        raise AssertionError("data axis: calibrate(mesh=)'s statistics "
                             "miss the single process's (above)")
    route_gate("data axis: the mesh solve",
               "the batched route on the same statistics",
               same["error_rel"], same["codeword_share"],
               same["total_error_rel"])
    route_gate("data axis: calibrate(mesh=) then the mesh solve",
               "the batched route on the single process's statistics",
               single["error_rel"], single["codeword_share"],
               single["total_error_rel"], layer_rtol=DP_PIPELINE_LAYER_RTOL,
               min_share=0.0, total_rtol=DP_PIPELINE_TOTAL_RTOL)
    return m


def run_data_axis(dev, cfg, card, single):
    """Phase 13, the data axis: two replicas in this process, then two
    ranks (replica serving, data-parallel calibration, the mesh solve).
    Returns its metrics."""
    start = time.perf_counter()
    m, tokens = run_replicas(dev, cfg, card, single)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        m.update(run_data_ranks(cfg, card, tmp, tokens))
    m["phase_s"] = time.perf_counter() - start
    log(f"data axis: the phase took {m['phase_s']:.1f} s ({card})")
    return m


def run_kernel_smoke(card):
    """``tools/gpu_kernel_smoke.py`` at its full geometries (8B-class K
    with the layernorm prologue, GQA decode at G = 4), its summary written
    to the git-ignored ``chiprun_out/gpu_kernel_smoke.json``: every case
    within the oracle's and its plain version's tolerance, and each naming
    the kernels it launched. Returns the summary's counts and extremes."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import gpu_kernel_smoke

    out = os.path.join(ROOT, "chiprun_out", "gpu_kernel_smoke.json")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    t0 = time.perf_counter()
    rc = gpu_kernel_smoke.main(["--out", out])
    secs = time.perf_counter() - t0
    with open(out) as f:
        summary = json.load(f)
    rows = summary["results"]
    if rc != 0 or summary["failed"] or not all(r["kernels"] for r in rows):
        raise AssertionError(f"gpu_kernel_smoke: rc {rc}, failed "
                             f"{summary['failed']}")
    slow = max(rows, key=lambda r: r["secs"])
    rel = max((r for r in rows if "max_rel_err" in r),
              key=lambda r: r["max_rel_err"])
    worst = {}
    for r in rows:
        if r.get("plain_err", 0) >= worst.get(r["plain_tol"], {}).get(
                "plain_err", -1):
            worst[r["plain_tol"]] = r
    m = {"cases": len(rows), "ok": summary["ok"], "seconds": secs,
         "slowest": [slow["case"], slow["secs"]],
         "worst_rel": [rel["case"], rel["max_rel_err"]],
         "worst_plain": {t: [r["case"], r["plain_err"]]
                         for t, r in worst.items()},
         "kernels": sorted({k for r in rows for k in r["kernels"]})}
    log(f"gpu_kernel_smoke: {m['ok']}/{m['cases']} cases OK in {secs:.1f} s, "
        f"every row naming its kernels ({', '.join(m['kernels'])}); slowest "
        f"{m['slowest']}, worst oracle distance {m['worst_rel']}, worst "
        f"plain distance by tolerance {json.dumps(m['worst_plain'])} "
        f"({card}; rows in {out})")
    return m


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device")
    start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"device: {torch.cuda.get_device_name(0)} ({smi}); torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")

    seconds = {}  # each phase's wall seconds

    def phase(name, fn, *a, **kw):
        t0 = time.perf_counter()
        try:
            return fn(*a, **kw)
        finally:
            seconds[name] = round(seconds.get(name, 0.0)
                                  + time.perf_counter() - t0, 1)

    built = phase("build", kernels.build, ptxas_verbose=True)
    log(f"build: {seconds['build']:.1f} s wall "
        + json.dumps({k: round(v['seconds'], 1) for k, v in built.items()}))
    if "dequant_matmul.cu" in built:
        stream_ptxas = ptxas_report(built["dequant_matmul.cu"]["log"],
                                    "pair_stream_kernel")
        log("ptxas, pair_stream_kernel (K1/K6/K7 at M <= 8): [registers, "
            "spill store bytes, spill load bytes] " + json.dumps(stream_ptxas))
    else:
        stream_ptxas = None
        log("ptxas: dequant_matmul.cu was built before this run, no report "
            "(python -m sleekit_tpu_torch.kernels rebuilds with one)")
    if "decode_attention.cu" in built:
        decode_ptxas = ptxas_report(built["decode_attention.cu"]["log"],
                                    "decode_kernel", decode_rule)
        if set(decode_ptxas) != {"K3 slot", "K5 pool"}:
            raise AssertionError(f"ptxas: the main path's decode_kernel "
                                 f"instantiations not found: {decode_ptxas}")
        log("ptxas, decode_kernel (K3/K5 on the main path: bf16 q, int8 "
            "cache, bf16 scales): [registers, spill store bytes, spill load "
            "bytes] " + json.dumps(decode_ptxas))
    else:
        decode_ptxas = None
        log("ptxas: decode_attention.cu was built before this run, no report")
    if "kv_append.cu" in built:
        append_ptxas = ptxas_report(built["kv_append.cu"]["log"],
                                    "append_kernel", append_rule)
        if set(append_ptxas) != {"K10 prefill", "K10/K14 T=1"}:
            raise AssertionError(f"ptxas: the main path's append_kernel "
                                 f"instantiations not found: {append_ptxas}")
        log("ptxas, append_kernel (K10/K14: bf16 rows, int8 cache, bf16 "
            "scales): [registers, spill store bytes, spill load bytes] "
            + json.dumps(append_ptxas))
    else:
        append_ptxas = None
        log("ptxas: kv_append.cu was built before this run, no report")
    if "plane_matmul.cu" in built:
        plane_log = built["plane_matmul.cu"]["log"]
        plane_ptxas = {
            **ptxas_report(plane_log, "pair_stream_kernel", plane_rule),
            **ptxas_report(plane_log, "pair_mma_kernel", plane_rule)}
        if len(plane_ptxas) != 8:
            raise AssertionError(f"ptxas: the 4-bit plane instantiations "
                                 f"not found: {plane_ptxas}")
        log("ptxas, 4-bit 'plane' routes (K8 NF4, K9 int4; mma WM x WN x "
            "MINB): [registers, spill store bytes, spill load bytes] "
            + json.dumps(plane_ptxas))
    else:
        plane_ptxas = None
        log("ptxas: plane_matmul.cu was built before this run, no report")
    if "plane_f32.cu" in built:
        f32_log = built["plane_f32.cu"]["log"]
        f32_ptxas = {
            **ptxas_report(f32_log, "stream_tf32_kernel", f32_rule),
            **ptxas_report(f32_log, "f32_tile_kernel", f32_rule)}
        if len(f32_ptxas) != 6:
            raise AssertionError(f"ptxas: the 4-bit K8f/K9f instantiations "
                                 f"not found: {f32_ptxas}")
        log("ptxas, 4-bit 'plane' f32 routes (K8f NF4, K9f int4; stream: "
            "mma.sync at M <= 8, TOK = 4 at M <= 4; tile: 128 x 128 wgmma; "
            "both split TF32): [registers, spill store bytes, spill load "
            "bytes] " + json.dumps(f32_ptxas))
        spilled = {k: v for k, v in f32_ptxas.items() if v[1] or v[2]}
        if spilled:
            raise AssertionError(f"ptxas: K8f/K9f spill: {spilled}")
    else:
        f32_ptxas = None
        log("ptxas: plane_f32.cu was built before this run, no report")

    if "prefill_attention.cu" in built:
        k4_ptxas = ptxas_report(built["prefill_attention.cu"]["log"],
                                "prefill_tf32_kernel", k4_f32_rule)
        if len(k4_ptxas) != 8:
            raise AssertionError(f"ptxas: K4's f32 instantiations not "
                                 f"found: {k4_ptxas}")
        log("ptxas, prefill_tf32_kernel (K4 f32, DP = D rounded up to 16): "
            "[registers, spill store bytes, spill load bytes] "
            + json.dumps(k4_ptxas))
        spilled = {k: v for k, v in k4_ptxas.items() if v[1] or v[2]}
        if spilled:
            raise AssertionError(f"ptxas: K4 f32 spills: {spilled}")
    else:
        k4_ptxas = None
        log("ptxas: prefill_attention.cu was built before this run, no "
            "report")

    cfg = opt_1b3(dtype=torch.bfloat16)
    g = torch.Generator().manual_seed(0)
    cases = phase("kernels", lambda: {
        **check_linears(dev, cfg, ["K1"]), "K2": check_k2(dev, g, cfg),
        "K3": check_k3(dev, g, cfg), "K4": check_k4(dev),
        **check_paged(dev, g, cfg)})
    k4_large = phase("kernels", check_k4_f32_large_logits, dev)
    # K10's first case, the one its row reports, is the main path's.
    cases["K10"] = phase("kernels", check_k10_prefill, dev) + cases["K10"]
    launches, engine, state = phase("engine", run_engine, dev, cfg, smi)
    paged_launches, paged_metrics, pool = phase(
        "paged_engine", run_paged_engine, dev, cfg, smi, state)
    launches["K5"] = paged_launches["K5"]
    split_launches, split_metrics = phase("split", run_split, dev, cfg,
                                          state, pool)
    for name, n in split_launches.items():   # K10: the main path's count
        launches.setdefault(name, n)
    engine.update(paged_metrics, **split_metrics)
    engine.update(phase("ew_engine", run_ew_engine, dev, cfg, state, smi))
    engine.update(phase("sampled", run_sampled, dev, cfg, state, smi))
    cases.update(phase("linears", check_linears, dev, cfg,
                       ["K6", "K7", "K8", "K9"]))
    cases.update(phase("linears_f32", check_linears_f32, dev, cfg))
    layout_launches, layout_metrics = phase("layouts", run_layouts, dev, cfg,
                                            smi, state)
    launches.update(layout_launches)
    engine.update(layout_metrics)
    engine.update(phase("perplexity", run_perplexity, dev, cfg, state, smi))
    del state, pool
    benches = phase("benches", run_benches, cfg, os.path.join(ROOT, "traces"))
    torch.cuda.empty_cache()
    quant = phase("quantize", run_quantize, dev,
                  dataclasses.replace(cfg, n_layers=QUANT_DEPTH), smi)
    torch.cuda.empty_cache()
    cli, path = phase("cli", run_cli, dev, smi)
    launches.update(path)
    torch.cuda.empty_cache()
    ablation = phase("ablation", run_ablation, smi)
    torch.cuda.empty_cache()
    tp, tp_cases = phase("tp", run_tp, dev, cfg, smi)
    for name, cs in tp_cases.items():
        cases[name] = cases[name] + cs   # after the main path's cases
    torch.cuda.empty_cache()
    data_axis = phase("data_axis", run_data_axis, dev, cfg, smi, engine)
    torch.cuda.empty_cache()
    kernel_smoke = phase("kernel_smoke", run_kernel_smoke, smi)

    rows = []
    for k in (K1, K2, K3, K4, K5, K6, K7, K8, K9, K10, K11, K12, K13, K14,
              K15, K8f, K9f):
        cs = cases[k.name]
        # K1, K6-K9 and K8f/K9f report one decode layer's four projections
        # (M = 8); the others their first case. Every case is listed under
        # "cases".
        main_cs = [c for c in cs if c["case"].endswith("M=8")] or cs[:1]

        def total(key, main_cs=main_cs):
            vals = [c[key] for c in main_cs]
            return None if any(v is None for v in vals) else sum(vals)

        rows.append(dict(
            name=k.name, route="cuda",
            source=f"sleekit_tpu_torch/csrc/{k.source}",
            replaces=k.replaces.split()[0], launches=launches[k.name],
            max_abs_err=max(c["max_abs_err"] for c in cs),
            ms=total("ms"), plain_ms=total("plain_ms"),
            bound_ms=total("bound_ms"),
            bound_by=main_cs[0]["bound_by"], library_ms=total("library_ms"),
            cases=cs))
    engine["ptxas_pair_stream_kernel"] = stream_ptxas
    engine["ptxas_decode_kernel"] = decode_ptxas
    engine["ptxas_plane"] = plane_ptxas
    engine["ptxas_plane_f32"] = f32_ptxas
    engine["ptxas_append_kernel"] = append_ptxas
    engine["ptxas_k4_f32"] = k4_ptxas
    engine["k4_f32_large_logits"] = k4_large
    seconds["total"] = round(time.perf_counter() - start, 1)
    log("phases (wall s): " + json.dumps(seconds))
    log(f"chip_smoke: {seconds['total']:.1f} s ({smi})")
    print(json.dumps({"kernels": rows, "engine": engine, "quantize": quant,
                      "cli": cli, "ablation": ablation, "tp": tp,
                      "data_axis": data_axis, "benches": benches,
                      "kernel_smoke": kernel_smoke, "phases": seconds}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
