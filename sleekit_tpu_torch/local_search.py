"""Best-first local-search refinement of a quantized weight matrix (port of
``sleekit_tpu/local_search.py``).

The state is ``P = (Q - W) @ H``. A move lets each output channel (row)
apply its single best profitable flip of one entry to the next codebook
value up or down; the gains of all candidates are closed-form from P and
diag(H), and after a move P takes a per-row rank-1 update
``P += d[:, None] * H[col]`` (no GEMM).
"""

from __future__ import annotations

import torch


def compute_gain(W: torch.Tensor, Q: torch.Tensor, H: torch.Tensor,
                 candidates: torch.Tensor) -> torch.Tensor:
    """Error improvement of moving Q to each single-entry candidate change:
    with D = C - Q, -D^2 diag(H) - 2 ((Q - W) @ H) * D."""
    D = candidates - Q
    return (-torch.square(D) * torch.diagonal(H)[None, :]
            - 2 * ((Q - W) @ H) * D)


def quantize_local_search(W: torch.Tensor, Q: torch.Tensor, H: torch.Tensor,
                          quantizer, nb_moves: int) -> torch.Tensor:
    """``nb_moves`` rounds of per-row best-flip refinement (up wins only
    where its gain beats down's; first column on ties)."""
    if nb_moves == 0:
        return Q
    W, Q, H = W.float(), Q.float().clone(), H.float()
    diag = torch.diagonal(H)[None, :]
    rows = torch.arange(Q.shape[0], device=Q.device)
    P = (Q - W) @ H
    for _ in range(nb_moves):
        Qup = quantizer.quantize_up(Q)
        Qdn = quantizer.quantize_down(Q)
        Dup = Qup - Q
        Ddn = Qdn - Q
        best_up, col_up = torch.max(-torch.square(Dup) * diag - 2 * P * Dup,
                                    dim=1)
        best_dn, col_dn = torch.max(-torch.square(Ddn) * diag - 2 * P * Ddn,
                                    dim=1)
        take_up = (best_up > best_dn) & (best_up > 0)
        take_dn = ~take_up & (best_dn > 0)
        col = torch.where(take_up, col_up, col_dn)
        cur = Q[rows, col]
        new_val = torch.where(take_up, Qup[rows, col_up],
                              torch.where(take_dn, Qdn[rows, col_dn], cur))
        d = new_val - cur              # exactly zero for rows with no move
        Q[rows, col] = cur + d
        P += d[:, None] * H[col]
    return Q
