"""The port's kernel smoke matrix on the GPU (the counterpart of
``tools/tpu_kernel_smoke.py``, case for case, on ``sleekit_tpu_torch``).

``chip_smoke.py`` runs the dequant-matmul kernels only at OPT-1.3B's shapes
(K <= 8192) and the decode kernels only at H = KV = 32. This tool launches
every kernel variant x layout x geometry, 8B-class K with the layernorm
prologue included (llama3-8b's gate|up at K 4096 and down at K 14336) and
GQA decode at G = 4, and holds each case two ways:

  * ``max_rel_err``: against a dense f32 oracle of the same function,
    max|out - oracle| / max|oracle| < 2e-2 (the JAX tool's tolerance;
    appends have no oracle, as there);
  * ``plain_err``: against the kernel's plain version on the same inputs,
    at the tolerance ``tests/test_torch_cuda.py`` holds that kernel to
    (``plain_tol``: 'bf16' rtol 2^-6 and atol 1e-2 max|plain|; 'ulp' one
    bf16 step, K12; 'f32' 1e-5 of max|plain|, K8f/K9f; 'f32_elem' rtol and
    atol 1e-5, K4's f32 route; 'exact' bit for bit, the appends and the
    bytes K3/K5 write);

and records ``kernels``, the port kernels that launched
(``kernels.KERNELS[*].launches``), so a row shows that a kernel ran and not
a plain route. On the card every row must name at least one.

Each row is named as ``TPU_KERNEL_SMOKE.json`` names the same case, except:

  * absent: ``dequant_matmul/nf4/plane-stacked`` (the port has no
    ``layer_sel``: a layer of a stacked weight is the view ``packed[l]``,
    ``ops/pack.py``);
  * added (:data:`ADDITIONS`): every dequant-matmul case again at M = 64
    under a ``/m64`` suffix (the port has a streaming route at M <= 8 and a
    tensor-core route above, where the TPU had one); the 'plane' cases and
    the flash prefill cases with f32 x under an ``-f32`` suffix (K8f/K9f
    and K4's f32 route, to which the JAX package sends f32); and
    ``flash_decode/mha32/ew`` (K12, the TPU's 'ew' mode).

``fused_decode_append/<tag>/int8-2blk`` puts the append in the second
split of the decode kernel (a cache of two ``decode_plan`` splits, every
position past the first), as the TPU case puts it in a second S-block.

Run on the card:
  python tools/gpu_kernel_smoke.py [--out GPU_KERNEL_SMOKE.json] [--quick]
      [--device cuda|cpu]
``--quick`` skips the 8B-class geometries; ``--device cpu`` runs the plain
versions (no kernel launches: a rehearsal of the cases, not a check of the
kernels). It prints a line a case and writes the summary (with the card's
name and power limit) to ``--out``; it exits 1 if any case fails.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# Dequant-matmul geometries (name, K, N): OPT-1.3B's fc1 and attention,
# then (without --quick) llama3-8b's gate|up and down. N keeps the JAX
# tool's cut of the 8B rows: the true K, a reduced N.
GEOMS = (("opt1.3b-fc1", 2048, 8192), ("opt1.3b-attn", 2048, 2048))
GEOMS_8B = (("llama8b-gateup", 4096, 8192), ("llama8b-down", 14336, 4096))
# The NF4 'plane' case's (K, N).
NF4_SHAPE = (2048, 2048)
# Flash prefill cases, tag: (B, KV, T, D, G, ALiBi), the TPU tool's.
PREFILL_CASES = {"mha": (2, 8, 512, 64, 1, False),
                 "gqa": (1, 4, 512, 128, 4, False),
                 "alibi": (1, 8, 256, 64, 1, True)}
# Tokens a dequant-matmul case: M = 8 (the TPU tool's) and the /m64 rows.
DECODE_M, PREFILL_M = 8, 64
ORACLE_TOL = 2e-2

# Cases this tool adds to TPU_KERNEL_SMOKE.json's names: each name there
# with /m64 (dequant matmul) or -f32 ('plane', flash prefill) applied, and
# these rows.
ADDITIONS = ("flash_decode/mha32/ew",)


def added_name(name: str, tpu_names) -> bool:
    """Whether ``name`` is a stated addition to the TPU tool's names."""
    if name in ADDITIONS:
        return True
    base = name[:-len("/m64")] if name.endswith("/m64") else name
    if base != name and base.startswith("dequant_matmul/"):
        name = base
        if name in tpu_names:
            return True
    if name.endswith("-f32"):
        base = name[:-len("-f32")]
        return base in tpu_names and (base.endswith("/plane")
                                      or base.startswith("flash_prefill/"))
    return False


def _flat(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


def _max_rel(got, ref) -> float:
    got, ref = got.double(), ref.double()
    return ((got - ref).abs().max() / (ref.abs().max() + 1e-9)).item()


def _plain_distance(got, want, tol: str):
    """(distance, within) of ``got`` from the plain version's ``want`` at
    the named tolerance."""
    g, w = got.double(), want.double()
    err = (g - w).abs()
    top = w.abs().max()
    if tol == "exact":
        return err.max().item(), bool(torch.equal(got, want))
    if tol == "bf16":
        bound = 2 ** -6 * w.abs() + 1e-2 * top
    elif tol == "ulp":
        bound = 2 ** -7 * w.abs() + 2 ** -14 * top
    elif tol == "f32":
        bound = 1e-5 * top
    elif tol == "f32_elem":
        bound = 1e-5 + 1e-5 * w.abs()
    else:
        raise ValueError(f"unknown tolerance {tol!r}")
    dist = (err.max() / (top + 1e-30)).item()
    return dist, bool(torch.isfinite(g).all()) and not bool((err > bound).any())


def _smi():
    """The card's ``name`` and ``power.limit`` as nvidia-smi gives them."""
    try:
        line = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return None, None
    name, _, limit = line.rpartition(",")
    return name.strip(), limit.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", default=os.path.join(REPO,
                                                  "GPU_KERNEL_SMOKE.json"))
    ap.add_argument("--quick", action="store_true",
                    help="skip the 8B-class geometries")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from sleekit_tpu_torch import kernels
    from sleekit_tpu_torch.codebooks import Codebook, UniformCodebook
    from sleekit_tpu_torch.device import resolve_device
    from sleekit_tpu_torch.ops import attention as at
    from sleekit_tpu_torch.ops import dequant_matmul as dq
    from sleekit_tpu_torch.ops import paged_attention as pat
    from sleekit_tpu_torch.ops.pack import (
        PackedLinear, pack_indices, pack_quantized)

    dev = resolve_device(args.device)
    on_card = dev.type == "cuda"
    start = time.time()
    if on_card:
        torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.RandomState(0)
    results = []

    def tensor(a, dtype=torch.bfloat16):
        return torch.as_tensor(np.asarray(a, np.float32)).to(dev, dtype)

    def record(name, run, oracle=None, plain=None, tol="bf16"):
        """Run one case: ``run()`` launches the kernel (a tensor, or the
        output and the tensors it wrote), ``oracle()`` the dense f32
        answer of its first output, ``plain()`` the plain version's (the
        rest of the outputs compared bit for bit)."""
        t0 = time.time()
        entry = {"case": name, "backend": dev.type}
        try:
            kernels.reset_launch_counts()
            out = _flat(run())
            if on_card:
                torch.cuda.synchronize()
            entry["kernels"] = sorted(k.name for k in kernels.KERNELS
                                      if k.launches)
            ok = bool(torch.isfinite(out[0].float()).all())
            if oracle is not None:
                entry["max_rel_err"] = round(_max_rel(out[0], oracle()), 6)
                ok = ok and entry["max_rel_err"] < ORACLE_TOL
            if plain is not None:
                want = _flat(plain())
                dist, within = _plain_distance(out[0], want[0], tol)
                for g, w in zip(out[1:], want[1:]):
                    within = within and bool(torch.equal(g, w))
                entry["plain_err"] = dist
                entry["plain_tol"] = tol
                ok = ok and within
            if on_card and not entry["kernels"]:
                ok = False
                entry["error"] = "no kernel launched"
            entry["ok"] = ok
        except Exception as e:  # noqa: BLE001 - record every failure mode
            entry["ok"] = False
            entry["error"] = f"{type(e).__name__}: {e}"[:500]
            traceback.print_exc(limit=2)
        entry["secs"] = round(time.time() - t0, 2)
        results.append(entry)
        print(f"  {'OK ' if entry['ok'] else 'FAIL'} {name} ({entry['secs']}s"
              + (f", rel={entry['max_rel_err']}" if "max_rel_err" in entry
                 else "")
              + (f", plain={entry['plain_err']:.3g} ({entry['plain_tol']})"
                 if "plain_err" in entry else "")
              + f", {' '.join(entry.get('kernels', [])) or '-'})",
              flush=True)

    # ---- dequant matmul: layout x nbits x glue fusion x geometry x M ---
    geoms = GEOMS + (() if args.quick else GEOMS_8B)
    for gname, K, N in geoms:
        W = torch.as_tensor(rng.randn(N, K).astype(np.float32) * 0.02).to(
            dev)
        xs = {m: rng.randn(m, K).astype(np.float32) * 0.1
              for m in (DECODE_M, PREFILL_M)}
        ln = (torch.ones(K, device=dev), torch.zeros(K, device=dev))
        for nbits in (3, 4, 8):
            layouts = (("int8",) if nbits == 8
                       else ("pair", "pair3", "pair3x", "plane")
                       if nbits == 3 else ("pair", "plane"))
            cb = UniformCodebook(2 ** nbits, -1.0, 1.0)
            scale = W.abs().amax(dim=1) + 1e-3
            for layout in layouts:
                p = pack_quantized(W, scale, cb, layout=layout)
                deq = p.dequantize()[:, :N]
                for m, suffix in ((DECODE_M, ""), (PREFILL_M, "/m64")):
                    name = f"dequant_matmul/{gname}/int{nbits}/{layout}"
                    dtypes = [(torch.bfloat16, "")]
                    if layout == "plane":
                        dtypes.append((torch.float32, "-f32"))
                    for dt, tag in dtypes:
                        x = tensor(xs[m], dt)
                        # (int8 pads N to 1024 at pack time: its first N
                        # columns are the function's.)
                        record(f"{name}{tag}{suffix}",
                               lambda x=x, p=p: dq.quantized_matmul(
                                   x, p, use_kernel=True)[:, :N],
                               oracle=lambda x=x, deq=deq: x.float() @ deq,
                               plain=lambda x=x, p=p: dq.quantized_matmul(
                                   x, p, use_kernel=False)[:, :N],
                               tol="f32" if dt == torch.float32 else "bf16")
                    if layout in ("pair", "pair3", "pair3x"):
                        # Glue fusion: pre-layernorm rides the kernel
                        # prologue, the full-K-row variant at 8B-class K.
                        x = tensor(xs[m])

                        def run_ln(x=x, p=p, use_kernel=True):
                            return dq.fused_quantized_matmul(
                                x, p, pre="layernorm", ln_scale=ln[0],
                                ln_bias=ln[1], use_kernel=use_kernel)

                        def ln_oracle(x=x, deq=deq):
                            return torch.nn.functional.layer_norm(
                                x.float(), (K,), *ln) @ deq
                        record(f"{name}+ln{suffix}", run_ln,
                               oracle=ln_oracle,
                               plain=lambda run_ln=run_ln: run_ln(
                                   use_kernel=False))
                del p, deq
        del W

    # ---- NF4 (table-codebook) LUT serving: the 'plane' kernels ---------
    Knf, Nnf = NF4_SHAPE
    nf4 = Codebook.nf4()
    idx_nf = torch.as_tensor(rng.randint(0, 16, (Knf, Nnf)))
    w_nf = PackedLinear(
        packed=pack_indices(idx_nf, 4, layout="plane").to(dev),
        scale=tensor(rng.rand(Nnf) + 0.5, torch.float32),
        lut=nf4.values.to(dev, torch.float32), bias=None, in_features=Knf,
        out_features=Nnf, nbits=4, affine=None, layout="plane")
    deq_nf = w_nf.dequantize()
    x_nf = {m: rng.randn(m, Knf).astype(np.float32) * 0.1
            for m in (DECODE_M, PREFILL_M)}
    for m, suffix in ((DECODE_M, ""), (PREFILL_M, "/m64")):
        for dt, tag in ((torch.bfloat16, ""), (torch.float32, "-f32")):
            x = tensor(x_nf[m], dt)
            record(f"dequant_matmul/nf4/plane{tag}{suffix}",
                   lambda x=x: dq.quantized_matmul(x, w_nf,
                                                   use_kernel=True),
                   oracle=lambda x=x: x.float() @ deq_nf,
                   plain=lambda x=x: dq.quantized_matmul(x, w_nf,
                                                         use_kernel=False),
                   tol="f32" if dt == torch.float32 else "bf16")

    def clones(*ts):
        return [None if t is None else t.clone() for t in ts]

    def attend_f32(q, k, v, pos, scale, k_scale=None, v_scale=None):
        """Dense f32 oracle of a decode step: q (B, H, D) over the rows s
        <= pos of k, v (B, KV, S, D) (int8 with (B, KV, S) scales)."""
        B, H, D = q.shape
        KV, S = k.shape[1], k.shape[2]
        k, v = k.float(), v.float()
        if k_scale is not None:
            k = k * k_scale.float()[..., None]
            v = v * v_scale.float()[..., None]
        q4 = q.float().reshape(B, KV, H // KV, D)
        lg = torch.einsum("bkgd,bksd->bkgs", q4, k) * scale
        p = torch.as_tensor(pos, device=dev).reshape(-1).expand(B)
        mask = torch.arange(S, device=dev)[None, :] <= p[:, None]
        lg = lg.masked_fill(~mask[:, None, None, :], -math.inf)
        return torch.einsum("bkgs,bksd->bkgd", torch.softmax(lg, -1),
                            v).reshape(B, H, D)

    # ---- flash decode: mode x GQA x int8 KV ----------------------------
    for kv, G, tag in ((32, 1, "mha32"), (8, 4, "gqa8x4")):
        B, S, D = 8, 256, 64
        ck = tensor(rng.randn(2, B, kv, S, D))
        cv = tensor(rng.randn(2, B, kv, S, D))
        q = tensor(rng.randn(B, kv * G, D))
        pos = torch.as_tensor(rng.randint(4, S - 1, (B,)), dtype=torch.int32,
                              device=dev)
        sc = 1.0 / np.sqrt(D)

        def oracle(q=q, ck=ck, cv=cv, pos=pos, sc=sc):
            return attend_f32(q, ck[1], cv[1], pos, sc)
        modes = [("dot", {"batch_fold": False}, "bf16"),
                 ("bfold", {"batch_fold": True}, "bf16")]
        if G == 1:
            modes.append(("ew", {"mha_mode": "ew"}, "ulp"))
        for mode, kw, tol in modes:
            def run(kw=kw, use_kernel=True, q=q, ck=ck, cv=cv, pos=pos,
                    sc=sc):
                if use_kernel:
                    return at.flash_decode(q, ck, cv, pos, 1, sc, **kw)
                plain = at.decode_route(q, ck, kw.get("mha_mode"),
                                        kw.get("batch_fold"))[1]
                return plain(q, ck, cv, pos, 1, sc)
            record(f"flash_decode/{tag}/{mode}", run, oracle=oracle,
                   plain=lambda run=run: run(use_kernel=False), tol=tol)

        # uniform + per-slot KV append, bf16 and int8
        kn = tensor(rng.randn(B, kv, D))
        vn = tensor(rng.randn(B, kv, D))
        cki = torch.zeros((2, B, kv, S, D), dtype=torch.int8, device=dev)
        ksc = torch.zeros((2, B, kv, S), dtype=torch.bfloat16, device=dev)
        for case, p, planes in (("ragged", pos, (ck, cv, None, None)),
                                ("uniform", 7, (ck, cv, None, None)),
                                ("int8", pos, (cki, cki, ksc, ksc))):
            def append(fn, p=p, planes=planes, kn=kn, vn=vn):
                k_, v_, ks_, vs_ = clones(*planes)
                return fn(kn, vn, k_, v_, p, 1, ks_, vs_)
            record(f"kv_append/{tag}/{case}",
                   lambda append=append: append(at.kv_append),
                   plain=lambda append=append: append(at.kv_append_plain),
                   tol="exact")

        # append-fused flash decode (the serving default): the attention
        # output against append-then-attend in f32, the written bytes
        # against the plain version's.
        def fused(fn, pos=pos, q=q, kn=kn, vn=vn, planes=(ck, cv, None,
                                                          None)):
            k_, v_, ks_, vs_ = clones(*planes)
            return fn(q, kn, vn, k_, v_, pos, 1, sc, None, ks_, vs_)

        def fused_oracle(fn_planes, pos=pos, q=q, kn=kn, vn=vn):
            k_, v_, ks_, vs_ = clones(*fn_planes)
            at.kv_append_plain(kn, vn, k_, v_, pos, 1, ks_, vs_)
            return attend_f32(q, k_[1], v_[1], pos, sc,
                              None if ks_ is None else ks_[1],
                              None if vs_ is None else vs_[1])
        record(f"fused_decode_append/{tag}/bf16",
               lambda fused=fused: fused(at.fused_decode_append),
               oracle=lambda fused_oracle=fused_oracle, ck=ck, cv=cv:
               fused_oracle((ck, cv, None, None)),
               plain=lambda fused=fused: fused(at.fused_decode_append_plain))

        R = at.decode_plan(B, kv, G, D, 1, S)[0]
        for case, S2, lo in (("int8", S, 4), ("int8-2blk", 2 * R, R)):
            cki2 = tensor(rng.randint(-127, 128, (2, B, kv, S2, D)),
                          torch.int8)
            ksc2 = tensor(0.01 + 0.05 * rng.rand(2, B, kv, S2),
                          torch.bfloat16)
            pos2 = torch.as_tensor(rng.randint(lo, S2 - 1, (B,)),
                                   dtype=torch.int32, device=dev)
            planes = (cki2, cki2.clone(), ksc2, ksc2.clone())
            record(f"fused_decode_append/{tag}/{case}",
                   lambda fused=fused, planes=planes, pos2=pos2: fused(
                       at.fused_decode_append, pos2, planes=planes),
                   oracle=lambda fused_oracle=fused_oracle, planes=planes,
                   pos2=pos2: fused_oracle(planes, pos2),
                   plain=lambda fused=fused, planes=planes, pos2=pos2: fused(
                       at.fused_decode_append_plain, pos2, planes=planes))

    # ---- paged kernels --------------------------------------------------
    B, kv, PS, D, MAXP = 4, 8, 64, 64, 4
    sc = 1.0 / np.sqrt(D)
    pool_k = tensor(rng.randn(2, 8, kv, PS, D))
    pool_v = tensor(rng.randn(2, 8, kv, PS, D))
    pt = torch.as_tensor(rng.randint(0, 8, (B, MAXP)), dtype=torch.int32,
                         device=dev)
    qq = tensor(rng.randn(B, kv, D))
    ppos = torch.as_tensor(rng.randint(4, MAXP * PS - 1, (B,)),
                           dtype=torch.int32, device=dev)

    def gathered(pool, table, layer, scales=None):
        return [None if t is None else pat._gathered(t, table, layer)
                for t in (pool[0], pool[1], *(scales or (None, None)))]

    record("paged_flash_decode/bf16",
           lambda: pat.paged_flash_decode(qq, pool_k, pool_v, pt, ppos, 0,
                                          sc),
           oracle=lambda: attend_f32(
               qq, *gathered((pool_k, pool_v), pt, 0)[:2], ppos, sc),
           plain=lambda: pat.paged_flash_decode_plain(qq, pool_k, pool_v, pt,
                                                      ppos, 0, sc))

    kn = tensor(rng.randn(B, kv, D))
    # The appends write through a table of distinct pages.
    pool2_k = tensor(rng.randn(2, B * MAXP + 1, kv, PS, D))
    pool2_v = tensor(rng.randn(2, B * MAXP + 1, kv, PS, D))
    pt2 = torch.as_tensor(1 + rng.permutation(B * MAXP).reshape(B, MAXP),
                          dtype=torch.int32, device=dev)

    def paged_append(fn):
        k_, v_ = clones(pool2_k, pool2_v)
        return fn(kn, kn, k_, v_, pt2, ppos, 1)
    record("paged_kv_append/bf16",
           lambda: paged_append(pat.paged_kv_append),
           plain=lambda: paged_append(pat.paged_kv_append_plain),
           tol="exact")

    # Fused append + flash decode over the pool.
    pool2_ki = tensor(rng.randint(-127, 128, tuple(pool2_k.shape)),
                      torch.int8)
    psc = tensor(0.01 + rng.rand(*pool2_k.shape[:-1]), torch.bfloat16)
    for case, planes in (("bf16", (pool2_k, pool2_v, None, None)),
                         ("int8", (pool2_ki, pool2_ki.clone(), psc,
                                   psc.clone()))):
        def paged_fused(fn, planes=planes):
            k_, v_, ks_, vs_ = clones(*planes)
            return fn(qq, kn, kn, k_, v_, pt2, ppos, 1, sc, None, ks_, vs_)

        def paged_oracle(planes=planes):
            k_, v_, ks_, vs_ = clones(*planes)
            pat.paged_kv_append_plain(kn, kn, k_, v_, pt2, ppos, 1, ks_,
                                      vs_)
            g = gathered((k_, v_), pt2, 1, (ks_, vs_))
            return attend_f32(qq, g[0], g[1], ppos, sc, g[2], g[3])
        record(f"paged_fused_decode_append/{case}",
               lambda paged_fused=paged_fused: paged_fused(
                   pat.paged_fused_decode_append),
               oracle=paged_oracle,
               plain=lambda paged_fused=paged_fused: paged_fused(
                   pat.paged_fused_decode_append_plain))

    # ---- flash prefill (GQA-native + ALiBi), bf16 and f32 ---------------
    for tag, (pB, pKV, pT, pD, pG, alibi) in PREFILL_CASES.items():
        pH = pKV * pG
        a_q = rng.randn(pB, pT, pH, pD)
        a_k = rng.randn(pB, pKV, pT, pD)
        a_v = rng.randn(pB, pKV, pT, pD)
        psl = (torch.linspace(0.02, 0.4, pH, device=dev) if alibi
               else None)
        psc = 1.0 / np.sqrt(pD)
        for dt, suffix, tol in ((torch.bfloat16, "", "bf16"),
                                (torch.float32, "-f32", "f32_elem")):
            pq, pk, pv = (tensor(a, dt) for a in (a_q, a_k, a_v))

            def prefill_oracle(pq=pq, pk=pk, pv=pv, psl=psl, psc=psc,
                               pG=pG, pT=pT):
                k = pk.float().repeat_interleave(pG, 1)
                v = pv.float().repeat_interleave(pG, 1)
                pos = torch.arange(pT, device=dev)
                dist = (pos[None, :] - pos[:, None]).float()
                lg = torch.einsum("bthd,bhsd->bhts", pq.float(), k) * psc
                if psl is not None:
                    lg = lg + psl[None, :, None, None] * dist
                lg = lg.masked_fill(dist > 0, -math.inf)
                return torch.einsum("bhts,bhsd->bthd", torch.softmax(lg, -1),
                                    v)
            record(f"flash_prefill/{tag}{suffix}",
                   lambda pq=pq, pk=pk, pv=pv, psl=psl, psc=psc:
                   at.flash_prefill(pq, pk, pv, psc, psl),
                   oracle=prefill_oracle,
                   plain=lambda pq=pq, pk=pk, pv=pv, psl=psl, psc=psc:
                   at.flash_prefill_plain(pq, pk, pv, psc, psl), tol=tol)

    n_ok = sum(r["ok"] for r in results)
    name, limit = _smi() if on_card else (None, None)
    summary = {"backend": dev.type,
               "name": name or (torch.cuda.get_device_name(dev) if on_card
                                else "cpu"),
               "power_limit": limit, "cases": len(results), "ok": n_ok,
               "failed": [r["case"] for r in results if not r["ok"]],
               "slowest": max(results, key=lambda r: r["secs"])["case"],
               "seconds": round(time.time() - start, 1), "results": results}
    with open(args.out, "w") as f:
        json.dump(summary, f, indent=1)
    print(f"{n_ok}/{len(results)} kernel cases OK on {summary['name']} "
          f"({limit}) in {summary['seconds']} s -> {args.out}")
    return 0 if n_ok == len(results) else 1


if __name__ == "__main__":
    sys.exit(main())
