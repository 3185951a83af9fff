"""Exact top-k by brute force: every row scored in fp32 (TF32 off), in
blocks of queries."""

from __future__ import annotations

import torch


@torch.no_grad()
def topk(rows: torch.Tensor, queries: torch.Tensor, k: int, block: int = 256):
    """(scores (Q, k) descending, indices (Q, k)) of (Q, D) queries
    against (N, D) rows."""
    ss, ii = [], []
    for q0 in range(0, queries.shape[0], block):
        s = queries[q0 : q0 + block] @ rows.T
        v, i = torch.topk(s, k, dim=1)
        ss.append(v)
        ii.append(i)
    return torch.cat(ss), torch.cat(ii)


@torch.no_grad()
def scores_of(rows: torch.Tensor, queries: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(Q, k) fp32 scores of the rows ``idx`` names for each query."""
    return (rows[idx] * queries[:, None, :]).sum(-1)
