"""Mamba-2 (SSD) block — attention-free sequence mixing (counterpart of
`repro.models.ssm`).

Layer = in_proj → causal depthwise conv (x|B|C channels) → SiLU → SSD scan
(`ssd_scan`, kernel K9, which also returns the final state) → gated
RMSNorm → out_proj. Decode carries (conv history, SSM state (B,H,P,N)) —
O(1) per token.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.models.common import Params, rmsnorm


def _dims(cfg: ModelConfig):
    d_inner = cfg.ssm_expand * cfg.d_model
    H = d_inner // cfg.ssm_headdim
    return d_inner, H, cfg.ssm_state, cfg.ssm_headdim


def init_ssm(cfg: ModelConfig, dtype: torch.dtype) -> Params:
    D = cfg.d_model
    d_inner, H, N, P = _dims(cfg)
    conv_ch = d_inner + 2 * N
    f32 = torch.float32
    p = Params()
    p.add("in_proj", (D, 2 * d_inner + 2 * N + H), dtype)
    p.add("conv_w", (cfg.ssm_conv, conv_ch), f32)
    p.add("conv_b", (conv_ch,), f32, init="zeros")
    p.add("dt_bias", (H,), f32, init="zeros")
    p.add("A_log", (H,), f32, init="zeros")
    p.add("D_skip", (H,), f32, init="ones")
    p.add("norm_scale", (d_inner,), f32, init="zeros")
    p.add("out_proj", (d_inner, D), dtype)
    return p


def _causal_conv(x, w, b):
    """Depthwise causal conv as a sum of K shifted products (the
    reference's arithmetic; not `F.conv1d`, which cuDNN runs in TF32).
    x: (B, S, Cch); w: (K, Cch)."""
    K, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = sum(xp[:, i:i + S] * w[i][None, None, :] for i in range(K))
    return out + b[None, None, :]


def _split_proj(p, x, cfg):
    d_inner, H, N, P = _dims(cfg)
    proj = x @ p["in_proj"]
    z, xbc, dt_raw = torch.split(proj, [d_inner, d_inner + 2 * N, H], dim=-1)
    return z, xbc, dt_raw


def _scan_inputs(p, xbc_f, dt_raw, cfg):
    """Conv → SiLU → the scan's (xs, dt, A, Bm, Cm), contiguous f32."""
    B, S = xbc_f.shape[:2]
    d_inner, H, N, P = _dims(cfg)
    conv_in = F.silu(_causal_conv(xbc_f, p["conv_w"], p["conv_b"]))
    xs, Bm, Cm = torch.split(conv_in, [d_inner, N, N], dim=-1)
    xs = xs.reshape(B, S, H, P).contiguous()
    dt = F.softplus(dt_raw.to(torch.float32) + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    return xs, dt, A, Bm.contiguous(), Cm.contiguous()


def _scan_out(p, y, xs, z, x_dtype, cfg):
    B, S = xs.shape[:2]
    d_inner = _dims(cfg)[0]
    y = y + p["D_skip"][None, None, :, None] * xs
    y = y.reshape(B, S, d_inner)
    y = rmsnorm(y * F.silu(z.to(torch.float32)), p["norm_scale"])
    return y.to(x_dtype) @ p["out_proj"]


def ssm_forward(p, x, cfg: ModelConfig) -> torch.Tensor:
    z, xbc, dt_raw = _split_proj(p, x, cfg)
    xs, dt, A, Bm, Cm = _scan_inputs(p, xbc.to(torch.float32), dt_raw, cfg)
    y, _ = ssd_scan(xs, dt, A, Bm, Cm, chunk=cfg.ssm_chunk)
    return _scan_out(p, y, xs, z, x.dtype, cfg)


def ssm_prefill(p, x, cfg: ModelConfig):
    """`ssm_forward` that also returns the decode cache: the last K−1
    conv inputs (zero-padded on the left for a short prompt) and the
    scan's final state."""
    S = x.shape[1]
    z, xbc, dt_raw = _split_proj(p, x, cfg)
    xbc_f = xbc.to(torch.float32)
    xs, dt, A, Bm, Cm = _scan_inputs(p, xbc_f, dt_raw, cfg)
    y, hT = ssd_scan(xs, dt, A, Bm, Cm, chunk=cfg.ssm_chunk)
    out = _scan_out(p, y, xs, z, x.dtype, cfg)
    K = cfg.ssm_conv - 1
    conv_hist = xbc_f[:, -K:] if S >= K else F.pad(xbc_f, (0, 0, K - S, 0))
    return out, {"conv": conv_hist.contiguous(), "state": hT}


# ------------------------------------------------------------- decoding ----
def init_ssm_cache(cfg: ModelConfig, batch: int, device) -> dict:
    d_inner, H, N, P = _dims(cfg)
    conv_ch = d_inner + 2 * N
    return {"conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_ch),
                                dtype=torch.float32, device=device),
            "state": torch.zeros((batch, H, P, N), dtype=torch.float32,
                                 device=device)}


def ssm_decode(p, x, cache: dict, cfg: ModelConfig):
    """x: (B, 1, D) → (y (B, 1, D), new cache)."""
    B = x.shape[0]
    d_inner, H, N, P = _dims(cfg)
    z, xbc, dt_raw = _split_proj(p, x, cfg)
    xbc = xbc[:, 0].to(torch.float32)                                # (B, Cch)
    hist = torch.cat([cache["conv"], xbc[:, None]], dim=1)           # (B, K, Cch)
    conv_out = torch.einsum("bkc,kc->bc", hist, p["conv_w"]) + p["conv_b"]
    xs, Bm, Cm = torch.split(F.silu(conv_out), [d_inner, N, N], dim=-1)
    xs = xs.reshape(B, H, P)
    dt = F.softplus(dt_raw[:, 0].to(torch.float32) + p["dt_bias"])  # (B, H)
    A = -torch.exp(p["A_log"])
    a = torch.exp(dt * A[None, :])
    dtx = dt[..., None] * xs
    state = a[..., None, None] * cache["state"] + dtx[..., None] * Bm[:, None, None, :]
    y = torch.einsum("bhpn,bn->bhp", state, Cm) + p["D_skip"][None, :, None] * xs
    y = y.reshape(B, 1, d_inner)
    y = rmsnorm(y * F.silu(z.to(torch.float32)), p["norm_scale"])
    out = y.to(x.dtype) @ p["out_proj"]
    return out, {"conv": hist[:, 1:].contiguous(), "state": state}
