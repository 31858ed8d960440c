"""Plain PyTorch version of the fused IVF cell probe (K4).

Candidates are laid out probe-major, slot-minor — the order the kernel and
the reference's stable merge rank exact ties in — and ranked by a stable
descending sort, never `torch.topk`.
"""

from __future__ import annotations

import math

import torch


def ivf_probe_stream_ref(probe: torch.Tensor, cell_rows: torch.Tensor,
                         cells: torch.Tensor, q: torch.Tensor, k: int):
    """Top-k of ⟨row, q⟩ over the probed cells.

    Args:
      probe: (nprobe,) cell ids, in probe order.
      cell_rows: (nlist, cap, d) rows grouped by cell (pad slots zero).
      cells: (nlist, cap) int32 row ids, −1 in pad slots.

    Returns ``(ids int32 (k,), scores f32 (k,), n_valid int32 ())`` with
    id −1 and score −inf past the valid candidates.
    """
    p = probe.to(torch.int64)
    ids = cells[p].reshape(-1)
    scores = (cell_rows[p].to(torch.float32) @ q.to(torch.float32)).reshape(-1)
    valid = ids >= 0
    scores = scores.masked_fill(~valid, -math.inf)
    top_s, pos = torch.sort(scores, descending=True, stable=True)
    top_s, pos = top_s[:k], pos[:k]
    out_ids = torch.where(torch.isfinite(top_s), ids[pos], -1).to(torch.int32)
    short = k - top_s.shape[0]
    if short > 0:  # fewer candidates than k at all
        out_ids = torch.cat([out_ids, out_ids.new_full((short,), -1)])
        top_s = torch.cat([top_s, top_s.new_full((short,), -math.inf)])
    return out_ids, top_s, valid.sum().to(torch.int32)
