"""Plain PyTorch version of GQA attention with the framework's mask modes
(counterpart of `repro.kernels.flash_attention.ref`): the oracle of K8,
which the wrapper runs for CPU tensors. It builds the whole (Sq × Skv)
logit matrix in f32.
"""

from __future__ import annotations

import torch


def make_mask(sq: int, skv: int, mode: str, window: int = 0,
              q_offset: int = 0, device=None) -> torch.Tensor:
    """(sq, skv) boolean mask; True = attend.

    Row i's *global* position is ``q_offset + i`` (decode: q_offset = cache
    position). Modes: full | causal | window (sliding, size `window`) |
    chunk (attend within `window`-sized chunks, causal inside).
    """
    qpos = q_offset + torch.arange(sq, device=device)[:, None]
    kpos = torch.arange(skv, device=device)[None, :]
    if mode == "full":
        return torch.ones((sq, skv), dtype=torch.bool, device=device)
    if mode == "causal":
        return kpos <= qpos
    if mode == "window":
        return (kpos <= qpos) & (kpos > qpos - window)
    if mode == "chunk":
        return (kpos <= qpos) & ((kpos // window) == (qpos // window))
    raise ValueError(f"unknown mask mode {mode!r}")


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  mode: str = "causal", window: int = 0, q_offset: int = 0,
                  scale: float | None = None,
                  logit_softcap: float = 0.0) -> torch.Tensor:
    """GQA attention oracle.

    q: (B, Hq, Sq, D); k, v: (B, Hkv, Skv, D) with Hq % Hkv == 0.
    Returns (B, Hq, Sq, D) in q's dtype; softmax in f32; a row that sees
    no key gives zeros.
    """
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    g = Hq // Hkv
    scale = scale if scale is not None else D ** -0.5
    qf = q.to(torch.float32) * scale
    kf = k.to(torch.float32).repeat_interleave(g, dim=1)
    vf = v.to(torch.float32).repeat_interleave(g, dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", qf, kf)
    if logit_softcap > 0:
        logits = logit_softcap * torch.tanh(logits / logit_softcap)
    mask = make_mask(Sq, Skv, mode, window, q_offset, device=q.device)
    logits = logits.masked_fill(~mask[None, None], -torch.inf)
    w = torch.softmax(logits, dim=-1)
    w = torch.nan_to_num(w, nan=0.0)  # fully-masked rows → zero output
    out = torch.einsum("bhqk,bhkd->bhqd", w, vf)
    return out.to(q.dtype)
