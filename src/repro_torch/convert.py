"""Carry the reference's state across into the port.

Each function takes arrays of the JAX package as numpy (``np.asarray`` of
a `jax.Array` is one) and builds the port's counterpart on ``device``, so
one input can drive both packages: the query matrix and histogram, the
carried `MWEMState`, an IVF build (without re-running it), and a factored
marginal workload. A wave carries over the same way: a (B, U) state and a
per-lane (B, U) histogram keep their shapes, one row a lane. Nothing here
imports the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.mwem import MWEMState
from repro_torch.core.workload import MarginalWorkload
from repro_torch.device import resolve_device
from repro_torch.mips.ivf import IVFIndex


def tensor(x, device=None, dtype=torch.float32) -> torch.Tensor:
    """A numpy-convertible array — the (m, U) queries, the (U,) histogram
    or a wave's (B, U) histograms — as a tensor of ``dtype`` on
    ``device``, shape unchanged."""
    return torch.as_tensor(np.array(x), dtype=dtype).to(resolve_device(device))


def mwem_state(log_w, p_sum, device=None) -> MWEMState:
    """`MWEMState` from the reference's ``(log_w, p_sum)``: (U,) each for
    one lane, or (B, U) each for a wave (a batched `repro` state)."""
    return MWEMState(log_w=tensor(log_w, device), p_sum=tensor(p_sum, device))


def ivf_index(vectors, cents, cells, nprobe: int | None = None,
              approx_margin: float = 0.0, failure_mass: float | None = None,
              device=None) -> IVFIndex:
    """`IVFIndex` from the reference build's rows, centroids and −1-padded
    cell table (its ``_v``, ``_cents`` and ``_cells``)."""
    return IVFIndex.from_tables(np.array(vectors), cents, cells, nprobe=nprobe,
                                approx_margin=approx_margin,
                                failure_mass=failure_mass, device=device)


def marginal_workload(card, cliques, score_block: int = 512,
                      clique_chunk: int = 32, device=None) -> MarginalWorkload:
    """The port's `MarginalWorkload` of the reference's
    ``MarginalWorkload(card, cliques, score_block=..., clique_chunk=...)``:
    built by the same mixed-radix construction, so its int32 tables
    (q_clique, q_offset, cl_dstride, cl_card, cl_stride, cl_cells) equal
    the reference instance's pytree leaves."""
    return MarginalWorkload(card, cliques, score_block=score_block,
                            clique_chunk=clique_chunk, device=device)

