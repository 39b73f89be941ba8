"""Best-first local-search refinement of a quantized weight matrix (port of
``sleekit_tpu/local_search.py``).

The state is ``P = (Q - W) @ H``. A move lets each output channel (row)
apply its single best profitable flip of one entry to the next codebook
value up or down; the gains of all candidates are closed-form from P and
diag(H), and after a move P takes a per-row rank-1 update
``P += d[:, None] * H[col]`` (no GEMM). A stack of layers (L, m, n),
H (L, n, n), moves every row of every layer at once.
"""

from __future__ import annotations

import torch

from sleekit_tpu_torch.hessian import diag_of


def compute_gain(W: torch.Tensor, Q: torch.Tensor, H: torch.Tensor,
                 candidates: torch.Tensor) -> torch.Tensor:
    """Error improvement of moving Q to each single-entry candidate change:
    with D = C - Q, -D^2 diag(H) - 2 ((Q - W) @ H) * D."""
    D = candidates - Q
    return (-torch.square(D) * diag_of(H)[..., None, :]
            - 2 * ((Q - W) @ H) * D)


def _at(X: torch.Tensor, col: torch.Tensor) -> torch.Tensor:
    """X[..., r, col[..., r]]: one entry a row."""
    return torch.take_along_dim(X, col[..., None], dim=-1)[..., 0]


def quantize_local_search(W: torch.Tensor, Q: torch.Tensor, H: torch.Tensor,
                          quantizer, nb_moves: int) -> torch.Tensor:
    """``nb_moves`` rounds of per-row best-flip refinement (up wins only
    where its gain beats down's; first column on ties)."""
    if nb_moves == 0:
        return Q
    W, Q, H = W.float(), Q.float().clone(), H.float()
    diag = diag_of(H)[..., None, :]
    P = (Q - W) @ H
    for _ in range(nb_moves):
        Qup = quantizer.quantize_up(Q)
        Qdn = quantizer.quantize_down(Q)
        Dup = Qup - Q
        Ddn = Qdn - Q
        best_up, col_up = torch.max(-torch.square(Dup) * diag - 2 * P * Dup,
                                    dim=-1)
        best_dn, col_dn = torch.max(-torch.square(Ddn) * diag - 2 * P * Ddn,
                                    dim=-1)
        take_up = (best_up > best_dn) & (best_up > 0)
        take_dn = ~take_up & (best_dn > 0)
        col = torch.where(take_up, col_up, col_dn)
        cur = _at(Q, col)
        new_val = torch.where(take_up, _at(Qup, col_up),
                              torch.where(take_dn, _at(Qdn, col_dn), cur))
        d = new_val - cur              # exactly zero for rows with no move
        Q.scatter_(-1, col[..., None], (cur + d)[..., None])
        # H[col] a row: each layer's row of its own Hessian.
        P += d[..., None] * torch.take_along_dim(H, col[..., None], dim=-2)
    return Q
