"""GPTQ/OBQ error-compensating solver (port of ``sleekit_tpu/solver.py``).

Per column i of the (permuted) weights: q = quantize(w_i), err = (w_i -
q) / Hinv[i, i], and the block's later columns get -= err * Hinv[i, i+1:];
after a block of columns one GEMM corrects every later column,
Q[:, e:] -= E @ Hinv[block, e:]. The JAX package runs the sweep as one
compiled program; here it is a Python loop of tensor ops on the weights'
device (about a dozen small launches a column), every row (output
channel) at once.

Every function takes one layer, W (m, n) and H (n, n), or a stack of
independent layers of one shape, W (L, m, n) and H (L, n, n): the same
ops over a leading layer axis, so a column of the sweep is one set of
launches for all L layers (the JAX package's ``vmap``).
"""

from __future__ import annotations

import torch

from sleekit_tpu_torch.hessian import (
    diag_of, dampen, hessian_inv_chol, hessian_inv_chol_robust)

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
    """Mean channel error (one a layer of a stack)."""
    return torch.mean(channelwise_error(W, Q, H), dim=-1)


# ---- column orderings ------------------------------------------------------


def permute_columns(X: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """X[..., order]: each layer's columns in its own order (a gather)."""
    return torch.take_along_dim(X, order[..., None, :], dim=-1)


def permute_hessian(H: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """H[order][:, order] for each layer of a stack."""
    return permute_columns(
        torch.take_along_dim(H, order[..., :, None], dim=-2), order)


def cholesky_ordering(H: torch.Tensor) -> torch.Tensor:
    """Greedy pivoted-Cholesky ordering: step k pivots on the largest
    remaining diagonal of the Schur complement (first on ties), one
    argmax a layer a step. O(n^3)."""
    n = H.shape[-1]
    ar = torch.arange(n, device=H.device)
    L = H.clone()
    order = ar.expand(H.shape[:-1]).clone()
    for k in range(n):
        d = torch.abs(diag_of(L))
        pivot = torch.argmax(torch.where(ar >= k, d, -torch.inf), dim=-1,
                             keepdim=True)
        perm = ar.expand(order.shape).clone()
        perm[..., k:k + 1] = pivot
        perm.scatter_(-1, pivot, k)
        L = permute_hessian(L, perm)
        order = torch.take_along_dim(order, perm, dim=-1)
        b = L[..., k, :] * (ar > k).to(L.dtype)
        L = L - (b[..., :, None] * b[..., None, :]) / L[..., k, k, None,
                                                        None]
    return order


def compute_order(W: torch.Tensor, H: torch.Tensor, quantizer,
                  act_order: str) -> torch.Tensor:
    """Column ordering for the greedy sweep: ``diag`` (GPTQ's default),
    ``err``, ``sqerr`` (diagonal times squared rounding error, sleekit's),
    ``combined_diag``, ``inv_diag``, ``pivot`` or ``none``. A stable sort:
    tied keys keep their column order, as ``jnp.argsort``."""
    diag = diag_of(H)
    if act_order == "diag":
        key = -diag
    elif act_order == "err":
        key = -diag * torch.sum(torch.abs(quantizer(W) - W), dim=-2)
    elif act_order == "sqerr":
        key = -diag * torch.sum(torch.square(quantizer(W) - W), dim=-2)
    elif act_order == "combined_diag":
        key = -diag / diag_of(torch.linalg.inv(H))
    elif act_order == "inv_diag":
        key = diag_of(torch.linalg.inv(H))
    elif act_order == "pivot":
        return cholesky_ordering(H)
    elif act_order == "none":
        return torch.arange(W.shape[-1], device=W.device).expand(
            diag.shape)
    else:
        raise ValueError(f"Invalid act_order value {act_order}")
    return torch.argsort(key, dim=-1, stable=True)


# ---- blocked error-compensating sweep --------------------------------------


def gptq_sweep(W: torch.Tensor, Hinv: torch.Tensor, quantizer,
               block_size: int = 128) -> torch.Tensor:
    """Blocked greedy sweep: quantize the columns left to right with error
    compensation. ``Hinv`` is the upper Cholesky factor of the (dampened,
    permuted) inverse Hessian. Returns Q in W's column order.

    A ragged last block is shorter: the JAX package pads it with columns
    whose Hinv is the identity, which quantize nothing and add zeros."""
    n = W.shape[-1]
    B = min(block_size, n)
    Q = W.float().clone()
    Hinv = Hinv.float()
    for start in range(0, n, B):
        end = min(start + B, n)
        Qb = Q[..., start:end].clone()
        Hb = Hinv[..., start:end, start:end]
        Eb = torch.empty_like(Qb)
        for i in range(end - start):
            w = Qb[..., i]
            q = quantizer(w)
            err = torch.div(w - q, Hb[..., i, i, None], out=Eb[..., i])
            Qb[..., i + 1:] -= err[..., :, None] * Hb[..., i, None, i + 1:]
            Qb[..., i] = q
        # Every later column, corrected by one GEMM.
        if end < n:
            Q[..., end:] -= Eb @ Hinv[..., start:end, end:]
        Q[..., start:end] = Qb
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
    first attempt succeeds; each layer of a stack on its own)."""
    if (W.ndim not in (2, 3)
            or H.shape != (*W.shape[:-2], W.shape[-1], W.shape[-1])):
        raise ValueError(f"quantize_opt takes W ([L,] m, n) and H ([L,] n, "
                         f"n), not {tuple(W.shape)} and {tuple(H.shape)}")
    W = W.float()
    H = H.float()
    H_opt = dampen(H, damp)
    order = compute_order(W, H_opt, quantizer, act_order)
    if damp_retry:
        Hinv, _ = hessian_inv_chol_robust(permute_hessian(H, order), damp)
    else:
        Hinv = hessian_inv_chol(permute_hessian(H_opt, order))
    Qp = gptq_sweep(permute_columns(W, order), Hinv, quantizer,
                    block_size=block_size)
    Q = permute_columns(Qp, torch.argsort(order, dim=-1))
    if nb_ls_moves > 0:
        from sleekit_tpu_torch.local_search import quantize_local_search

        Q = quantize_local_search(W, Q, H, quantizer, nb_ls_moves)
    return Q
