"""Plain PyTorch versions of the fused MWEM step (K2) and the lazy-EM tail
scorer (K3).

`mwu_apply_ref` is the multiplicative-weights update expression of
`repro.kernels.mwem_step.ref`, op for op: every update ends with
``log_w −= max(log_w)``, so the carried log-weights have max 0 and the
carried density ``p`` equals ``softmax(log_w)`` — the driver carries
``(log_w, p, p_sum)`` and never recomputes a softmax.
"""

from __future__ import annotations

import torch

UPDATE_RULES = ("paper", "signed", "hardt")


def mwu_apply_ref(log_w, p, q_row, h, noise, *, rule: str, eta: float):
    """One MW update given the selected row and the realized noise →
    ``(log_w', p')`` with ``max(log_w') == 0``, ``p' = softmax(log_w')``."""
    if rule == "paper":
        lw = log_w - eta * q_row
    else:
        measured = q_row @ h + noise
        est = q_row @ p
        if rule == "signed":
            lw = log_w + eta * torch.sign(measured - est) * q_row
        elif rule == "hardt":
            lw = log_w + q_row * (measured - est) / 2.0
        else:
            raise ValueError(f"unknown update rule {rule!r}")
    lw = lw - torch.max(lw)
    e = torch.exp(lw)
    return lw, e / torch.sum(e)


def mwem_step_ref(log_w, p, p_sum, q_rows, sel, h, noise, *, rule: str,
                  eta: float):
    """MWU + renormalize + accumulate with winner row ``q_rows[sel]`` →
    ``(log_w', p', p_sum + p')``."""
    sel = torch.as_tensor(sel, device=q_rows.device).reshape(1)
    noise = torch.as_tensor(noise, dtype=torch.float32,
                            device=q_rows.device).reshape(())
    # index_select keeps the id on the device (no host read of `sel`)
    q_row = q_rows.index_select(0, sel).reshape(-1)
    lw, p_new = mwu_apply_ref(log_w, p, q_row, h, noise, rule=rule, eta=eta)
    return lw, p_new, p_sum + p_new


def gather_score_ref(q_rows, v, aug_idx, active=None):
    """``sign · ⟨q_rows[j % m], v⟩`` for augmented ids ``j`` (sign +1 if
    ``j < m`` else −1); 0 where ``active`` is False."""
    m = q_rows.shape[0]
    aug = aug_idx.to(torch.int64)
    base = torch.remainder(aug, m)
    sign = torch.where(aug < m, 1.0, -1.0).to(torch.float32)
    out = (q_rows[base] @ v) * sign
    if active is not None:
        out = torch.where(active, out, torch.zeros_like(out))
    return out


def mwem_step_batch_ref(log_w, p, p_sum, q_rows, sel, h, noise, *, rule: str,
                        eta: float):
    """`mwem_step_ref` lane by lane over (B, U) state, (B,) ``sel`` and
    ``noise``, and a shared (U,) or per-lane (B, U) ``h`` — so lane b's
    numbers are exactly the single-lane plain version's."""
    lanes = [mwem_step_ref(log_w[b], p[b], p_sum[b], q_rows, sel[b],
                           h if h.dim() == 1 else h[b], noise[b], rule=rule,
                           eta=eta) for b in range(log_w.shape[0])]
    return tuple(torch.stack(parts) for parts in zip(*lanes))


def gather_score_batch_ref(q_rows, V, aug_idx, active=None):
    """`gather_score_ref` lane by lane: row b of the (B, C) ids is scored
    against ``V[b]``."""
    return torch.stack([
        gather_score_ref(q_rows, V[b], aug_idx[b],
                         None if active is None else active[b])
        for b in range(aug_idx.shape[0])])
