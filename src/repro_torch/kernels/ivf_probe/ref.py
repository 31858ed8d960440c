"""Plain PyTorch versions of the fused IVF cell probe (K4) and of the
wave-batched probe (K5), with the wave's probe planning.

Single probe: candidates are laid out probe-major, slot-minor — the order
the kernel and the reference's stable merge rank exact ties in — and
ranked by a stable descending sort, never `torch.topk`.

Wave: `batch_probe_slots` plans the deduplicated union of the cells the
lanes probe, in ascending cell id order; each lane's candidates lie in
that slot order (slot-major, row-minor), masked to the lane's own cells.
So on exact score ties a batched lane can pick a different, equally
scoring candidate than a single-lane probe, which ranks in probe order —
the only way the two are observably different (as in the reference's
`repro.kernels.ivf_probe.ref`).
"""

from __future__ import annotations

import math

import torch


def _pad_topk(ids: torch.Tensor, scores: torch.Tensor, k: int):
    """Pad the last axis to ``k`` with id −1 and score −inf."""
    short = k - scores.shape[-1]
    if short > 0:  # fewer candidates than k at all
        ids = torch.cat([ids, ids.new_full((*ids.shape[:-1], short), -1)], -1)
        scores = torch.cat(
            [scores, scores.new_full((*scores.shape[:-1], short), -math.inf)], -1)
    return ids, scores


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
    out_ids, top_s = _pad_topk(out_ids, top_s, k)
    return out_ids, top_s, valid.sum().to(torch.int32)


def batch_probe_slots(cents: torch.Tensor, Vb: torch.Tensor, nprobe: int):
    """Probe planning of a wave of B probe vectors ``Vb`` (B, d).

    One (B × d) @ (d × nlist) product ranks each lane's cells; a stable
    descending sort takes its top ``nprobe`` (ties to the lower cell id).
    Returns ``(slots, member, probe)``:

    - ``slots`` (B·nprobe,) int32: the unique probed cells, ascending, then
      a duplicate tail pinned to the last unique cell;
    - ``member`` (B·nprobe, B) f32: 1 where the lane probed the slot's cell,
      0 in every lane for the duplicate tail;
    - ``probe`` (B, nprobe) int32: each lane's probed cells, best first.
    """
    cscores = Vb.to(torch.float32) @ cents.to(torch.float32).T
    probe = torch.sort(cscores, dim=1, descending=True,
                       stable=True).indices[:, :nprobe]
    flat = torch.sort(probe.reshape(-1)).values
    uniq = torch.ones_like(flat, dtype=torch.bool)
    uniq[1:] = flat[1:] != flat[:-1]
    # unique cells first (ascending), duplicates squeezed to the tail
    slots = flat[torch.sort((~uniq).to(torch.uint8), stable=True).indices]
    slot_valid = torch.sort(uniq.to(torch.uint8), descending=True,
                            stable=True).values.to(torch.bool)
    slots = torch.where(slot_valid, slots, flat[-1])
    member = ((slots[:, None, None] == probe[None, :, :]).any(-1)
              & slot_valid[:, None]).to(torch.float32)
    return slots.to(torch.int32), member, probe.to(torch.int32)


def ivf_probe_stream_batch_ref(slots: torch.Tensor, member: torch.Tensor,
                               cell_rows: torch.Tensor, cells: torch.Tensor,
                               Vb: torch.Tensor, k: int):
    """Per-lane top-k of ⟨row, Vb[b]⟩ over the planned slots.

    Args:
      slots / member: the plan of `batch_probe_slots`.
      cell_rows: (nlist, cap, d) rows grouped by cell (pad slots zero).
      cells: (nlist, cap) int32 row ids, −1 in pad slots.
      Vb: (B, d) probe vectors.

    Returns ``(ids int32 (B, k), scores f32 (B, k), n_valid int32 (B,))``
    with id −1 and score −inf past a lane's valid candidates; ``n_valid``
    counts the valid rows of the lane's own probed cells.
    """
    s = slots.to(torch.int64)
    cand = cells[s]                                       # (S, cap)
    scores = torch.einsum("scd,bd->bsc", cell_rows[s].to(torch.float32),
                          Vb.to(torch.float32))           # (B, S, cap)
    in_lane = member.T > 0                                # (B, S)
    valid = cand >= 0
    scores = scores.masked_fill(~(valid[None] & in_lane[:, :, None]), -math.inf)
    B = Vb.shape[0]
    flat_s = scores.reshape(B, -1)
    top_s, pos = torch.sort(flat_s, dim=1, descending=True, stable=True)
    top_s, pos = top_s[:, :k], pos[:, :k]
    ids = torch.where(torch.isfinite(top_s), cand.reshape(-1)[pos], -1)
    ids, top_s = _pad_topk(ids.to(torch.int32), top_s, k)
    n_valid = (in_lane * valid.sum(1)[None, :]).sum(1).to(torch.int32)
    return ids, top_s, n_valid
