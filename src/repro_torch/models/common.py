"""Shared model machinery: parameter groups, norms, RoPE (counterpart of
`repro.models.common`, without its sharding context).

A layer's parameters are a `Params` group, read as ``p["name"]`` the way
the reference reads its parameter dicts, so each layer function takes the
same arguments as its counterpart. A group records each parameter's
initialiser at the reference's scale — a normal draw times fan_in^-½
(fan_in = the first axis of a matrix, the length of a vector), or zeros
or ones — and is created on the ``meta`` device: `fill_` materialises it
from a `torch.Generator` on the model's device.
"""

from __future__ import annotations

import torch
import torch.nn as nn


class Params(nn.Module):
    """A named group of parameters with their initialisers."""

    def __init__(self):
        super().__init__()
        self._inits: dict[str, tuple[str, float | None]] = {}

    def add(self, name: str, shape, dtype: torch.dtype, *, init: str = "normal",
            scale: float | None = None) -> None:
        if init not in ("normal", "zeros", "ones"):
            raise ValueError(f"unknown initialiser {init!r}")
        if scale is None and init == "normal":
            fan_in = shape[0] if len(shape) > 1 else max(shape[-1], 1)
            scale = fan_in ** -0.5
        self.register_parameter(name, nn.Parameter(
            torch.empty(tuple(shape), dtype=dtype, device="meta"),
            requires_grad=False))
        self._inits[name] = (init, scale)

    def __getitem__(self, name: str) -> torch.Tensor:
        return getattr(self, name)

    @torch.no_grad()
    def fill_(self, gen: torch.Generator) -> None:
        """Draw every parameter in place (normals in f32, then cast)."""
        for name, (init, scale) in self._inits.items():
            p = getattr(self, name)
            if init == "zeros":
                p.zero_()
            elif init == "ones":
                p.fill_(1.0)
            else:
                p.copy_(torch.randn(p.shape, generator=gen, device=p.device,
                                    dtype=torch.float32) * scale)


# ------------------------------------------------------------------ norms --
def rmsnorm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMS norm scaled by (1 + γ): γ starts at zero (the reference's init)."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + gamma.to(torch.float32))
    return out.to(x.dtype)


def layernorm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    out = (xf - mu) * torch.rsqrt(var + eps) * gamma.to(torch.float32) \
        + beta.to(torch.float32)
    return out.to(x.dtype)


def apply_norm(x, p, norm_type: str, eps: float):
    if norm_type == "layernorm":
        return layernorm(x, p["scale"], p["bias"], eps)
    return rmsnorm(x, p["scale"], eps)


def init_norm(d: int, norm_type: str) -> Params:
    p = Params()
    p.add("scale", (d,), torch.float32,
          init="zeros" if norm_type == "rmsnorm" else "ones")
    if norm_type == "layernorm":
        p.add("bias", (d,), torch.float32, init="zeros")
    return p


# ------------------------------------------------------------------- rope --
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate-half RoPE. x: (B, H, S, D); positions: (B, S) int. The two
    halves of D (not interleaved pairs) are the rotated coordinates."""
    D = x.shape[-1]
    freqs = rope_freqs(D, theta, device=x.device)                   # (D/2,)
    ang = positions[:, None, :, None].to(torch.float32) * freqs      # (B,1,S,D/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
