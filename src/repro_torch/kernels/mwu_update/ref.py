"""Plain PyTorch version of the fused multiplicative-weights update (K7).

Op for op the expression of `repro.kernels.mwu_update.ref.mwu_update_ref`:
``lw' = lw + coef·c``, then ``m = max(lw')``, ``e = exp(lw' − m)``,
``s = Σe`` and ``p = e / s`` along the last axis.
"""

from __future__ import annotations

import torch


def mwu_update_ref(lw: torch.Tensor, c: torch.Tensor, coef: float,
                   rows: torch.Tensor | None = None):
    """``(lw', p, m, s)`` for one row ``lw`` (U,) or rows (B, U).

    ``c`` is the update direction of the same shape, or with ``rows`` an
    (n, U) table of which row ``rows[b]`` updates row b (``rows`` (B,)
    int64, or one id for a single row). ``m`` and ``s`` are 0-d for a
    single row, (B,) for rows.
    """
    if rows is not None:
        c = c.index_select(0, rows.reshape(-1).to(torch.int64))
        c = c.reshape(lw.shape)
    out = lw + coef * c
    m = torch.amax(out, dim=-1)
    e = torch.exp(out - m.unsqueeze(-1))
    s = torch.sum(e, dim=-1)
    return out, e / s.unsqueeze(-1), m, s
