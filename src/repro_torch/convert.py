"""Carry the reference's state across into the port.

Each function takes arrays of the JAX package as numpy (``np.asarray`` of
a `jax.Array` is one) and builds the port's counterpart on ``device``, so
one input can drive both packages: the query matrix and histogram, the
carried `MWEMState`, an IVF build (without re-running it), and a factored
marginal workload. A wave carries over the same way: a (B, U) state and a
per-lane (B, U) histogram keep their shapes, one row a lane. An LM's
parameter and cache pytrees, stacked over each stage's layer units, come
apart into the port's per-layer state dict and cache list. Nothing here
imports the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
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



def _leaf(x) -> torch.Tensor:
    """A numpy array as a CPU tensor of its dtype; bfloat16 (numpy's
    ``ml_dtypes`` type) goes through f32, which holds it exactly."""
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _layers(stages_tree: dict, cfg: ModelConfig):
    """(layer index, one layer's subtree) in the reference's layer order:
    stage by stage, unit by unit, the pattern's blocks in turn. Every
    leaf of ``stages_tree[f"stage_{si}"]`` is stacked (n_units, ...)."""
    layer = 0
    for si, (pattern, n_units) in enumerate(cfg.stages):
        stage = stages_tree[f"stage_{si}"]
        for u in range(n_units):
            for bi in range(len(pattern)):
                yield layer, _unstack(stage[f"block_{bi}"], u)
                layer += 1


def _unstack(tree, u: int):
    if isinstance(tree, dict):
        return {k: _unstack(v, u) for k, v in tree.items()}
    return np.asarray(tree)[u]


def _flatten(tree: dict, prefix: str, out: dict) -> None:
    for k, v in tree.items():
        if isinstance(v, dict):
            _flatten(v, f"{prefix}{k}.", out)
        else:
            out[f"{prefix}{k}"] = _leaf(v)


def lm_params(params_np: dict, cfg: ModelConfig) -> dict:
    """The port's `LM` state dict from the reference's parameter pytree
    (``repro.models.LM.init``'s params as numpy arrays): the embedding
    (and untied head) under ``io.``, ``final_norm.``, and each layer's
    groups under ``blocks.<i>.``, unstacked from the per-stage
    (n_units, ...) leaves. Load it with ``LM(cfg).load(state, device)``."""
    state = {"io.embedding": _leaf(params_np["embedding"])}
    if "lm_head" in params_np:
        state["io.lm_head"] = _leaf(params_np["lm_head"])
    for layer, tree in _layers(params_np, cfg):
        _flatten(tree, f"blocks.{layer}.", state)
    _flatten(params_np["final_norm"], "final_norm.", state)
    return state


def lm_cache(cache_np: dict, cfg: ModelConfig, device=None) -> list:
    """The port's decode cache — one dict a layer, batch on axis 0 — from
    the reference's cache pytree (``LM.prefill`` / ``init_cache``'s
    stacked leaves as numpy arrays)."""
    dev = resolve_device(device)
    return [{k: _leaf(v).to(dev) for k, v in tree.items()}
            for _, tree in _layers(cache_np, cfg)]
