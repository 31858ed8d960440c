"""K9's two-launch split and `plan`, replayed on the CPU.

The CUDA kernels of ``src/repro_torch/csrc/ssd_scan.cu`` run only on the
card, where `chip_smoke.py` holds them to their plain version. Here their
decomposition is replayed in torch and held to the reference: C·Bᵀ once a
(batch, chunk) — B and C are shared by every head — and then each slice of
Ps state rows of a head walking the chunks on its own (cum in order, W made
from CB, y's slice columns and the slice's state rows), in the kernel's
exp2 form, against the reference's Pallas kernel in interpret mode (y) and
`ssd_chunked_jnp` (y and the final state) at rtol/atol 2e-4, the tolerance
`chip_smoke.py` holds the kernel to (f32 sums in another order). Cases: a
ragged last chunk, S < Q, P no multiple of Ps, N = 1.
"""

from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan import ssd_chunked_jnp
from repro.kernels.ssd_scan import ssd_scan as jax_ssd_scan

from repro_torch.kernels.ssd_scan.ops import (MAX_CHUNK, MAX_N, MAX_P, PS, plan,
                                              smem_bytes)

TOL = dict(rtol=2e-4, atol=2e-4)
SMEM_PER_SM = 228 * 1024  # H100: shared memory an SM, 1 KB of it reserved a block
LOG2E = 1.4426950408889634


# --------------------------------------------------------------- the plan

def test_plan_at_the_prefill_shape():
    p = plan(4, 580, 24, 64, 128, 64)
    assert p["Ps"] == 32 and p["slices"] == 2 and p["grid"] == (2, 24, 4)
    assert p["chunks"] == 10 and p["cb_grid"] == (10, 4, 4)
    assert p["cb_floats"] == 4 * 10 * 64 * 64


@pytest.mark.parametrize("P", [1, 7, 8, 9, 15, 16, 17, 31, 32, 33, 64, 100, 128])
@pytest.mark.parametrize("HB", [1, 7, 132])
def test_plan_slice_covers_the_card(P, HB):
    p = plan(HB, 70, 1, P, 16, 64)
    assert p["Ps"] == PS and p["slices"] == -(-P // PS)
    assert p["grid"] == (p["slices"], 1, HB)
    assert (p["slices"] - 1) * PS < P <= p["slices"] * PS  # no empty slice


def test_plan_slice_does_not_follow_the_grid():
    for P in (17, 64):
        assert {plan(1, 65, h, P, 32, 64)["Ps"] for h in (1, 66, 131, 132, 133, 528)} \
            == {PS}


@pytest.mark.parametrize("N,Q", [(MAX_N, MAX_CHUNK), (5, 64), (128, 16)])
def test_two_blocks_share_an_sm(N, Q):
    assert 2 * (smem_bytes(PS, N, Q) + 1024) <= SMEM_PER_SM


def test_plan_limits():
    for args in ((1, 10, 1, MAX_P + 1, 8, 8), (1, 10, 1, 8, MAX_N + 1, 8),
                 (1, 10, 1, 8, 8, MAX_CHUNK + 1), (0, 10, 1, 8, 8, 8),
                 (1, 0, 1, 8, 8, 8), (1, 10, 1, 0, 8, 8)):
        with pytest.raises(ValueError):
            plan(*args)


# ------------------------------------------------- the two-launch replay

def _two_launch(x, dt, A, Bm, Cm, Q, ps):
    """Launch 1: CB[b, c] = C_c·B_cᵀ once a (batch, chunk). Launch 2: every
    slice of ps state rows of a head walks the chunks on its own, with the
    kernel's arithmetic (cum in order, scaled by log2 e, exp2)."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    nc = -(-S // Q)
    pad = nc * Q - S  # rows past S: zeros with dt = 0
    xp = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
    dtp = torch.nn.functional.pad(dt, (0, 0, 0, pad))
    Bp = torch.nn.functional.pad(Bm, (0, 0, 0, pad))
    Cp = torch.nn.functional.pad(Cm, (0, 0, 0, pad))
    Bc = Bp.reshape(Bsz, nc, Q, N)
    Cc = Cp.reshape(Bsz, nc, Q, N)
    cb = Cc @ Bc.transpose(-1, -2)                                 # (B, nc, Q, Q)
    tri = torch.tril(torch.ones(Q, Q, dtype=torch.bool))
    y = torch.zeros_like(xp)
    hT = torch.zeros(Bsz, H, P, N)
    for p0 in range(0, P, ps):
        sl = slice(p0, min(P, p0 + ps))
        st = torch.zeros(Bsz, H, sl.stop - p0, N)
        for c in range(nc):
            rows = slice(c * Q, (c + 1) * Q)
            dtc = dtp[:, rows].permute(0, 2, 1)                    # (B, H, Q)
            cum = torch.cumsum(dtc * A[None, :, None], -1) * LOG2E
            W = cb[:, c, None] * torch.exp2(cum[..., :, None] - cum[..., None, :]) \
                * dtc[..., None, :]
            W = torch.where(tri, W, torch.zeros(()))
            xc = xp[:, rows, :, sl].permute(0, 2, 1, 3)            # (B, H, Q, ps)
            yi = W @ xc
            ye = (Cc[:, c, None] @ st.transpose(-1, -2)) * torch.exp2(cum)[..., None]
            y[:, rows, :, sl] = (yi + ye).permute(0, 2, 1, 3)
            w = torch.exp2(cum[..., -1:] - cum) * dtc
            st = torch.exp2(cum[..., -1])[..., None, None] * st \
                + (xc * w[..., None]).transpose(-1, -2) @ Bc[:, c, None]
        hT[:, :, sl] = st
    return y[:, :S], hT


def _inputs(seed, b, s, h, p, n, zero_dt=False, cum64=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = rng.uniform(0.01, 0.5, (b, s, h)).astype(np.float32)
    A = (-rng.uniform(0.1, 2.0, (h,))).astype(np.float32)
    if zero_dt:
        dt[:, ::3] = 0.0
    if cum64:
        dt[:] = 0.5
        A[:] = -2.0
    return (x, dt, A, rng.standard_normal((b, s, n)).astype(np.float32),
            rng.standard_normal((b, s, n)).astype(np.float32))


@pytest.mark.parametrize("s,chunk,p,n", [
    (37, 64, 17, 5),     # S < Q, ragged
    (45, 16, 33, 12),    # a ragged last chunk
    (7, 8, 8, 1),        # S under the least chunk, N = 1
    (130, 64, 17, 128),  # P under one slice
    (64, 16, 4, 128),    # whole chunks
    (100, 64, 33, 1),    # N = 1, ragged
    (1, 64, 17, 5),      # one step
    (129, 64, 100, 16),  # P = 100 over four slices, the last of 4 rows
])
def test_split_replay_matches_reference(s, chunk, p, n):
    args = _inputs(s * 13 + p, 2, s, 3, p, n)
    Q = min(chunk, max(8, s))
    targs = tuple(map(torch.as_tensor, args))
    jargs = tuple(map(jnp.asarray, args))
    y_kern = np.asarray(jax_ssd_scan(*jargs, chunk=chunk, interpret=True))
    y_chk, h_chk = (np.asarray(a) for a in ssd_chunked_jnp(*jargs, chunk=Q))
    y, hT = _two_launch(*targs, Q, PS)
    np.testing.assert_allclose(y.numpy(), y_kern, **TOL)
    np.testing.assert_allclose(y.numpy(), y_chk, **TOL)
    np.testing.assert_allclose(hT.numpy(), h_chk, **TOL)


@pytest.mark.parametrize("kind", ["zero_dt", "cum64"])
def test_split_replay_extreme_decays(kind):
    args = _inputs(5, 1, 128, 2, 16, 32, **{kind: True})
    targs = tuple(map(torch.as_tensor, args))
    y_chk, h_chk = (np.asarray(a) for a in ssd_chunked_jnp(*map(jnp.asarray, args),
                                                           chunk=64))
    y, hT = _two_launch(*targs, 64, PS)
    scale = max(1.0, float(np.abs(y_chk).max()), float(np.abs(h_chk).max()))
    np.testing.assert_allclose(y.numpy(), y_chk, rtol=2e-4, atol=2e-4 * scale)
    np.testing.assert_allclose(hT.numpy(), h_chk, rtol=2e-4, atol=2e-4 * scale)
    if kind == "cum64":  # cum reaches −64 in a chunk: the state nearly resets
        assert math.isfinite(float(hT.abs().max()))
