"""Plain PyTorch version of the streaming top-k MIPS kernel (K1).

Tie order is explicit — a stable descending sort, never `torch.topk`,
which promises none: ``plain`` and ``abs`` rank equal scores by lower row
id (as `jax.lax.top_k`); ``aug`` lists row j's +score (id j) and −score
(id j+n) side by side before sorting, so ties go to the lower row and,
within one row, to +id before −id.
"""

from __future__ import annotations

import torch


def mips_topk_ref(V: torch.Tensor, q: torch.Tensor, k: int, mode: str = "plain"):
    """Top-k of ⟨V_j, q⟩ → ``(ids int32 (k,), scores f32 (k,))``."""
    s = V.to(torch.float32) @ q.to(torch.float32)
    n = s.shape[0]
    ids = torch.arange(n, device=s.device)
    if mode == "abs":
        s = s.abs()
    elif mode == "aug":
        s = torch.stack([s, -s], dim=1).reshape(-1)
        ids = torch.stack([ids, ids + n], dim=1).reshape(-1)
    elif mode != "plain":
        raise ValueError(f"unknown mips_topk mode {mode!r}")
    top_s, pos = torch.sort(s, descending=True, stable=True)
    return ids[pos[:k]].to(torch.int32), top_s[:k]
