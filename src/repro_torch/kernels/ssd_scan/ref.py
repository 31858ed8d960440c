"""Plain PyTorch versions of the Mamba-2 SSD scan (counterpart of
`repro.kernels.ssd_scan.ref`).

`ssd_scan_ref` is the literal sequential recurrence (the ground truth):

    h_t = exp(dt_t A) · h_{t−1} + (dt_t x_t) ⊗ B_t,   y_t = h_t C_t

`ssd_chunked` is the chunked (state-space duality) formulation — quadratic
within chunks, linear state passing across chunks — and the plain version
of K9, which the wrapper runs for CPU tensors. Both return the output and
the final state.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def ssd_scan_ref(x, dt, A, Bm, Cm):
    """Sequential SSD recurrence.

    x: (B, S, H, P); dt: (B, S, H) > 0; A: (H,) < 0; Bm/Cm: (B, S, N).
    Returns y: (B, S, H, P), final state (B, H, P, N). All f32.
    """
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    x, dt, A, Bm, Cm = (t.to(torch.float32) for t in (x, dt, A, Bm, Cm))
    h = torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        a = torch.exp(dt[:, t] * A[None, :])                       # (B,H)
        dtx = dt[:, t, :, None] * x[:, t]                          # (B,H,P)
        h = a[..., None, None] * h + dtx[..., None] * Bm[:, t, None, None, :]
        ys.append(torch.einsum("bhpn,bn->bhp", h, Cm[:, t]))
    return torch.stack(ys, dim=1), h


def ssd_chunked(x, dt, A, Bm, Cm, chunk: int = 64, h0=None):
    """Chunked SSD, same signature and returns as `ssd_scan_ref`, plus an
    optional initial state. Padding steps (S to a chunk multiple) carry
    dt = 0: the identity transition with zero input."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    x, dt, A, Bm, Cm = (t.to(torch.float32) for t in (x, dt, A, Bm, Cm))
    pad = (-S) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    nc = (S + pad) // chunk
    xc = x.reshape(Bsz, nc, chunk, H, P)
    dtc = dt.reshape(Bsz, nc, chunk, H)
    Bc = Bm.reshape(Bsz, nc, chunk, N)
    Cc = Cm.reshape(Bsz, nc, chunk, N)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.float32,
                                device=x.device))
    h = (torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
         if h0 is None else h0.to(torch.float32))
    ys = []
    for c in range(nc):
        xq, dtq, bq, cq = xc[:, c], dtc[:, c], Bc[:, c], Cc[:, c]
        cum = torch.cumsum(dtq * A[None, None, :], dim=1)            # (B,Q,H)
        # intra: W[i,j] = (C_i·B_j)·exp(cum_i − cum_j)·dt_j, j ≤ i
        sij = torch.einsum("bin,bjn->bij", cq, bq)
        decay = torch.exp(cum[:, :, None, :] - cum[:, None, :, :])  # (B,Q,Q,H)
        W = sij[..., None] * decay * tri[None, :, :, None] * dtq[:, None]
        y_intra = torch.einsum("bijh,bjhp->bihp", W, xq)
        y_inter = torch.einsum("bin,bhpn->bihp", cq, h) * torch.exp(cum)[..., None]
        cum_last = cum[:, -1, :]                                     # (B,H)
        wj = torch.exp(cum_last[:, None, :] - cum) * dtq             # (B,Q,H)
        U = torch.einsum("bjhp,bjn->bhpn", xq * wj[..., None], bq)
        h = torch.exp(cum_last)[..., None, None] * h + U
        ys.append(y_intra + y_inter)
    y = torch.stack(ys, dim=1).reshape(Bsz, nc * chunk, H, P)[:, :S]
    return y, h
