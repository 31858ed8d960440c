"""The draw protocol: every random number one MWEM iteration consumes.

The JAX package draws from threefry keys (`repro.core.mwem.split_chain`,
the 4-way split inside `lazy_em_from_topk`, `fallback_key`). PyTorch cannot
reproduce those bits, so the port takes its randomness through `Draws`:
one method per draw the reference makes, each told the iteration ``t`` it
belongs to. The production implementation, `TorchDraws`, reads a
`torch.Generator` (Philox on the card) in call order and ignores ``t``; a
test implementation can walk the reference key chain instead and hand each
draw over as a tensor, which is how the port is held to the reference run
for run.
"""

from __future__ import annotations

from typing import Protocol

import torch

_TINY = torch.finfo(torch.float32).tiny


class Draws(Protocol):
    """Per-iteration draws, each returned on the caller's ``device``."""

    def topk_gumbel(self, t: int, k: int, device) -> torch.Tensor:
        """(k,) f32 standard Gumbels perturbing the lazy-EM top-k set."""
        ...

    def tail_count(self, t: int, trials: int, p: torch.Tensor) -> torch.Tensor:
        """0-d int64 Binomial(trials, p) count of tail Gumbels above the
        margin; ``p`` is the port's own 0-d tail probability."""
        ...

    def tail_randint(self, t: int, size: int, high: int, device) -> torch.Tensor:
        """(size,) int64 uniform complement-space ids in [0, high)."""
        ...

    def tail_uniform(self, t: int, size: int, device) -> torch.Tensor:
        """(size,) f32 uniforms in [0, 1) for the truncated tail Gumbels."""
        ...

    def exhaustive_gumbel(self, t: int, n: int, device) -> torch.Tensor:
        """(n,) f32 Gumbels of the exhaustive EM (``mode="exact"``)."""
        ...

    def fallback_gumbel(self, t: int, n: int, device) -> torch.Tensor:
        """(n,) f32 Gumbels of the exhaustive redo after a tail overflow —
        a stream of its own, apart from the lazy draw of the same step."""
        ...

    def laplace(self, t: int, device) -> torch.Tensor:
        """0-d f32 standard Laplace draw for the measurement."""
        ...


def gumbel_from_uniform(u: torch.Tensor) -> torch.Tensor:
    """Standard Gumbel by inversion, with ``u`` kept off 0."""
    return -torch.log(-torch.log(u.clamp_min(_TINY)))


class TorchDraws:
    """`Draws` from one `torch.Generator`, consumed in call order.

    The generator must live on the device the draws are wanted on (a CUDA
    generator draws Philox numbers on the card, with no host round-trip).
    """

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    @classmethod
    def seeded(cls, seed: int, device) -> "TorchDraws":
        return cls(torch.Generator(device=device).manual_seed(int(seed)))

    def _rand(self, size, device) -> torch.Tensor:
        return torch.rand(size, generator=self.generator, device=device,
                          dtype=torch.float32)

    def topk_gumbel(self, t, k, device):
        return gumbel_from_uniform(self._rand((k,), device))

    def tail_count(self, t, trials, p):
        # float64 keeps the trial count exact past 2**24 augmented ids
        p64 = p.to(torch.float64).reshape(())
        count = torch.full_like(p64, float(trials))
        return torch.binomial(count, p64, generator=self.generator).to(
            torch.int64)

    def tail_randint(self, t, size, high, device):
        return torch.randint(0, high, (size,), generator=self.generator,
                             device=device)

    def tail_uniform(self, t, size, device):
        return self._rand((size,), device)

    def exhaustive_gumbel(self, t, n, device):
        return gumbel_from_uniform(self._rand((n,), device))

    def fallback_gumbel(self, t, n, device):
        return gumbel_from_uniform(self._rand((n,), device))

    def laplace(self, t, device):
        u = self._rand((), device).clamp_min(_TINY)
        return torch.where(u < 0.5, torch.log(2.0 * u),
                           -torch.log(2.0 - 2.0 * u))
