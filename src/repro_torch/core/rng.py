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

A wave of B lanes draws through `LaneDraws`: it holds one `Draws` a lane
and stacks one draw of each lane into a (B, ...) tensor. Each lane consumes
its own source in exactly the order a single-lane `run_mwem` does, so lane
b of a batch equals `run_mwem` fed lane b's source.
"""

from __future__ import annotations

from typing import Protocol, Sequence

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


class LaneDraws:
    """One `Draws` a lane, each draw stacked over the lanes.

    Built from B `Draws` or B `torch.Generator`s (wrapped in `TorchDraws`).
    The batch driver asks for each kind of draw once an iteration, for all
    lanes, in the single-lane order; `fallback_gumbel` is asked only of the
    lanes whose tail buffer overflowed.
    """

    def __init__(self, lanes: Sequence):
        self.lanes = [TorchDraws(d) if isinstance(d, torch.Generator) else d
                      for d in lanes]
        if not self.lanes:
            raise ValueError("a wave needs at least one lane")

    @classmethod
    def seeded(cls, seeds: Sequence[int], device) -> "LaneDraws":
        return cls([TorchDraws.seeded(s, device) for s in seeds])

    def __len__(self) -> int:
        return len(self.lanes)

    def topk_gumbel(self, t, k, device):
        return torch.stack([d.topk_gumbel(t, k, device) for d in self.lanes])

    def tail_count(self, t, trials, p):
        """(B,) int64 counts; ``p`` is the (B,) per-lane tail probability."""
        return torch.stack([d.tail_count(t, trials, p[b])
                            for b, d in enumerate(self.lanes)])

    def tail_randint(self, t, size, high, device):
        return torch.stack([d.tail_randint(t, size, high, device)
                            for d in self.lanes])

    def tail_uniform(self, t, size, device):
        return torch.stack([d.tail_uniform(t, size, device) for d in self.lanes])

    def exhaustive_gumbel(self, t, n, device):
        return torch.stack([d.exhaustive_gumbel(t, n, device)
                            for d in self.lanes])

    def fallback_gumbel(self, t, n, device, lanes: Sequence[int]):
        """(len(lanes), n) fallback Gumbels of the listed lanes only."""
        return torch.stack([self.lanes[b].fallback_gumbel(t, n, device)
                            for b in lanes])

    def laplace(self, t, device):
        return torch.stack([d.laplace(t, device) for d in self.lanes])
