"""GPTQ/OBQ error-compensating solver (port of ``sleekit_tpu/solver.py``).

Per column i of the (permuted) weights: q = quantize(w_i), err = (w_i -
q) / Hinv[i, i], and the block's later columns get -= err * Hinv[i, i+1:];
after a block of columns one GEMM corrects every later column,
Q[:, e:] -= E @ Hinv[block, e:]. The JAX package runs the sweep as one
compiled program; here it is a Python loop of tensor ops on the weights'
device (about a dozen small launches a column), every row (output
channel) at once.
"""

from __future__ import annotations

import torch

from sleekit_tpu_torch.hessian import (
    dampen, hessian_inv_chol, hessian_inv_chol_robust)

ORDER_MODES = ("diag", "err", "sqerr", "combined_diag", "inv_diag", "pivot",
               "none")


# ---- error metrics ---------------------------------------------------------


def channelwise_error(W: torch.Tensor, Q: torch.Tensor,
                      H: torch.Tensor) -> torch.Tensor:
    """Per-output-channel quadratic error ((E @ H) * E).sum(-1), E = W - Q:
    the objective every part of the quantizer minimizes."""
    E = W - Q
    return torch.sum((E @ H) * E, dim=-1)


def quantization_error(W: torch.Tensor, Q: torch.Tensor,
                       H: torch.Tensor) -> torch.Tensor:
    """Mean channel error."""
    return torch.mean(channelwise_error(W, Q, H))


# ---- column orderings ------------------------------------------------------


def cholesky_ordering(H: torch.Tensor) -> torch.Tensor:
    """Greedy pivoted-Cholesky ordering: step k pivots on the largest
    remaining diagonal of the Schur complement (first on ties). O(n^3)."""
    n = H.shape[0]
    ar = torch.arange(n, device=H.device)
    L, order = H.clone(), ar.clone()
    for k in range(n):
        d = torch.abs(torch.diagonal(L))
        pivot = torch.argmax(torch.where(ar >= k, d, -torch.inf))
        perm = ar.clone()
        perm[k] = pivot
        perm.index_fill_(0, pivot.view(1), k)
        L = L[perm][:, perm]
        order = order[perm]
        b = L[k] * (ar > k).to(L.dtype)
        L = L - torch.outer(b, b) / L[k, k]
    return order


def compute_order(W: torch.Tensor, H: torch.Tensor, quantizer,
                  act_order: str) -> torch.Tensor:
    """Column ordering for the greedy sweep: ``diag`` (GPTQ's default),
    ``err``, ``sqerr`` (diagonal times squared rounding error, sleekit's),
    ``combined_diag``, ``inv_diag``, ``pivot`` or ``none``. A stable sort:
    tied keys keep their column order, as ``jnp.argsort``."""
    diag = torch.diagonal(H)
    if act_order == "diag":
        key = -diag
    elif act_order == "err":
        key = -diag * torch.sum(torch.abs(quantizer(W) - W), dim=0)
    elif act_order == "sqerr":
        key = -diag * torch.sum(torch.square(quantizer(W) - W), dim=0)
    elif act_order == "combined_diag":
        key = -diag / torch.diagonal(torch.linalg.inv(H))
    elif act_order == "inv_diag":
        key = torch.diagonal(torch.linalg.inv(H))
    elif act_order == "pivot":
        return cholesky_ordering(H)
    elif act_order == "none":
        return torch.arange(W.shape[1], device=W.device)
    else:
        raise ValueError(f"Invalid act_order value {act_order}")
    return torch.argsort(key, stable=True)


# ---- blocked error-compensating sweep --------------------------------------


def gptq_sweep(W: torch.Tensor, Hinv: torch.Tensor, quantizer,
               block_size: int = 128) -> torch.Tensor:
    """Blocked greedy sweep: quantize the columns left to right with error
    compensation. ``Hinv`` is the upper Cholesky factor of the (dampened,
    permuted) inverse Hessian. Returns Q in W's column order.

    A ragged last block is shorter: the JAX package pads it with columns
    whose Hinv is the identity, which quantize nothing and add zeros."""
    m, n = W.shape
    B = min(block_size, n)
    Q = W.float().clone()
    Hinv = Hinv.float()
    for start in range(0, n, B):
        end = min(start + B, n)
        Qb = Q[:, start:end].clone()
        Hb = Hinv[start:end, start:end]
        Eb = torch.empty_like(Qb)
        for i in range(end - start):
            w = Qb[:, i]
            q = quantizer(w)
            err = torch.div(w - q, Hb[i, i], out=Eb[:, i])
            Qb[:, i + 1:] -= err[:, None] * Hb[i, i + 1:]
            Qb[:, i] = q
        # Every later column, corrected by one GEMM.
        if end < n:
            Q[:, end:] -= Eb @ Hinv[start:end, end:]
        Q[:, start:end] = Qb
    return Q


# ---- top-level solve -------------------------------------------------------


def quantize_opt(W: torch.Tensor, H: torch.Tensor, quantizer,
                 act_order: str = "diag", damp: float = 0.01,
                 nb_ls_moves: int = 0, block_size: int = 128,
                 damp_retry: bool = True) -> torch.Tensor:
    """Quantize W minimizing the H-weighted squared error, GPTQ-style:
    dampen H, order the columns, permute, the inverse Cholesky factor, the
    blocked sweep, un-permute, then ``nb_ls_moves`` rounds of local
    search. ``damp_retry`` multiplies the dampening when the factor of a
    near-singular Hessian is not finite (the same result whenever the
    first attempt succeeds)."""
    if W.ndim != 2 or H.shape != (W.shape[1], W.shape[1]):
        raise ValueError(f"quantize_opt takes W (m, n) and H (n, n), not "
                         f"{tuple(W.shape)} and {tuple(H.shape)}")
    W = W.float()
    H = H.float()
    H_opt = dampen(H, damp)
    order = compute_order(W, H_opt, quantizer, act_order)
    if damp_retry:
        Hinv, _ = hessian_inv_chol_robust(H[order][:, order], damp)
    else:
        Hinv = hessian_inv_chol(H_opt[order][:, order])
    Qp = gptq_sweep(W[:, order], Hinv, quantizer, block_size=block_size)
    Q = Qp[:, torch.argsort(order)]
    if nb_ls_moves > 0:
        from sleekit_tpu_torch.local_search import quantize_local_search

        Q = quantize_local_search(W, Q, H, quantizer, nb_ls_moves)
    return Q
