"""Linear-query workloads: dense query matrices and factored k-way
marginals, counterpart of `repro.core.workload`.

Complement augmentation is a sign convention, not a row copy: augmented id
``j`` means query ``j % m`` with sign ``+1`` if ``j < m`` else ``−1``
(`aug_decompose`; decoded in the `gather_score` and
`marginal_gather_score` kernels).

`MarginalWorkload` holds k-way marginals over a factored categorical domain
``U = Π card[i]`` as int32 index maps on one device — per query only a
clique id and a cell offset. A clique's cell map (which marginal cell each
domain point lands in) is recomputed from ``arange(U)`` by mixed-radix
arithmetic whenever it is needed, so no (m, U) table is ever built on the
release path. Its segment sums (`marginal_tables`, the adaptive loop) go
through ``scatter_add_``; on CUDA that adds with atomics, so the order of
each sum — and its last bits — can change from run to run (f32
accumulation noise, compared at rtol 1e-5 with the reference).
"""

from __future__ import annotations

import itertools
from typing import Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device

# require_dense() refuses to materialize tables past this many bytes, as
# the reference does (`repro.core.workload._DENSIFY_LIMIT_BYTES`).
DENSIFY_LIMIT_BYTES = 2**31


def aug_decompose(aug_idx: torch.Tensor, m: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Augmented id → (int64 base query id, f32 ±1 sign) (§3.4 closure)."""
    aug = aug_idx.to(torch.int64)
    return (torch.remainder(aug, m),
            torch.where(aug < m, 1.0, -1.0).to(torch.float32))


class DenseWorkload:
    """An explicit ``(m, U)`` float32 query matrix on one device."""

    is_dense = True

    def __init__(self, Q: torch.Tensor):
        if Q.dim() != 2:
            raise ValueError(f"Q must be (m, U), got shape {tuple(Q.shape)}")
        self.Q = Q.to(torch.float32).contiguous()

    @property
    def m(self) -> int:
        return int(self.Q.shape[0])

    @property
    def U(self) -> int:
        return int(self.Q.shape[1])

    @property
    def device(self) -> torch.device:
        return self.Q.device

    def winner_table(self, sel: torch.Tensor):
        """``(row table, row ids)`` the fused step reads the winners from:
        the whole matrix and ``sel`` itself (one id, or (B,) for a wave)."""
        return self.Q, sel

    def scores(self, v: torch.Tensor) -> torch.Tensor:
        """All m signed scores ``Q v`` (the exhaustive oracle); a (B, U)
        block of probes gives (B, m), one ``(B, U) @ (U, m)`` product."""
        if v.dim() == 2:
            return v @ self.Q.T
        return self.Q @ v

    def max_err(self, h: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
        """‖Q(p − h)‖_∞ (Eq. 1); (B, U) densities (and a shared (U,) or
        per-lane (B, U) ``h``) give one error a lane."""
        if p.dim() == 2:
            return torch.amax(torch.abs((p - h) @ self.Q.T), dim=-1)
        return torch.max(torch.abs(self.Q @ (p - h)))

    def __repr__(self):
        return f"DenseWorkload(m={self.m}, U={self.U})"


class MarginalWorkload:
    """k-way marginal cells over a factored domain, rows kept implicit.

    Domain: mixed-radix product of ``card`` (last attribute fastest), so
    point ``u`` has digit ``(u // dstride[i]) % card[i]`` on attribute
    ``i``. A clique ``(a_1..a_k)`` defines a marginal table whose cell map
    ``cm_c(u) = Σ_j digit_{a_j}(u) · cstride_j``; query ``t`` is the
    indicator of cell ``q_offset[t]`` of clique ``q_clique[t]``. Cliques of
    fewer than ``kmax`` attributes are padded with card 1, domain stride 1
    and cell stride 0 (digit 0, adding nothing); cells past a clique's own
    count (``cl_cells``) are pad cells.

    Args:
      card: per-attribute cardinalities.
      cliques: attribute tuples, one marginal each.
      score_block: rows per block of the exhaustive oracle `scores`.
      clique_chunk: cliques per block of the segment sums.
      device: ``None`` places the tables on ``cuda`` (raising if absent);
        ``"cpu"`` for the plain PyTorch path.
    """

    is_dense = False

    def __init__(self, card: Sequence[int], cliques: Sequence[Sequence[int]],
                 *, score_block: int = 512, clique_chunk: int = 32,
                 device=None):
        dev = resolve_device(device)
        card = tuple(int(c) for c in card)
        cliques = tuple(tuple(int(a) for a in cl) for cl in cliques)
        if not cliques:
            raise ValueError("MarginalWorkload needs at least one clique")
        for cl in cliques:
            if len(set(cl)) != len(cl):
                raise ValueError(f"clique {cl} repeats an attribute")
            if any(a < 0 or a >= len(card) for a in cl):
                raise ValueError(f"clique {cl} references a missing "
                                 f"attribute (n_attrs={len(card)})")
        dstr = np.ones(len(card), np.int64)  # last attribute fastest
        for i in range(len(card) - 2, -1, -1):
            dstr[i] = dstr[i + 1] * card[i + 1]
        U = int(dstr[0] * card[0]) if card else 1
        if U >= 2**31:
            raise ValueError(f"domain size {U} overflows int32 cell maps")
        nc = len(cliques)
        kmax = max(len(cl) for cl in cliques)
        cl_dstride = np.ones((nc, kmax), np.int32)
        cl_card = np.ones((nc, kmax), np.int32)     # padding: card 1 → digit 0
        cl_stride = np.zeros((nc, kmax), np.int32)  # padding: stride 0
        cl_cells = np.ones((nc,), np.int32)
        qc, qo = [], []
        for c, cl in enumerate(cliques):
            strides = np.ones(len(cl), np.int64)
            for j in range(len(cl) - 2, -1, -1):
                strides[j] = strides[j + 1] * card[cl[j + 1]]
            ncells = int(strides[0] * card[cl[0]])
            cl_cells[c] = ncells
            for j, a in enumerate(cl):
                cl_dstride[c, j] = dstr[a]
                cl_card[c, j] = card[a]
                cl_stride[c, j] = strides[j]
            qc.append(np.full(ncells, c, np.int32))
            qo.append(np.arange(ncells, dtype=np.int32))
        self.card, self.cliques = card, cliques
        self._U, self.n_cliques, self.kmax = U, nc, kmax
        self.max_cells = int(cl_cells.max())
        self.score_block = int(score_block)
        self.clique_chunk = int(clique_chunk)
        q_clique = np.concatenate(qc)
        self._m = int(q_clique.shape[0])
        self._starts = np.concatenate([[0], np.cumsum(cl_cells)]).astype(np.int64)

        def put(a):
            return torch.as_tensor(a).to(dev)

        self.q_clique = put(q_clique)
        self.q_offset = put(np.concatenate(qo))
        self.cl_dstride = put(cl_dstride)
        self.cl_card = put(cl_card)
        self.cl_stride = put(cl_stride)
        self.cl_cells = put(cl_cells)
        self._u = torch.arange(U, dtype=torch.int32, device=dev)
        self._qc64 = self.q_clique.to(torch.int64)
        self._qo64 = self.q_offset.to(torch.int64)

    @classmethod
    def all_kway(cls, card: Sequence[int], k: int, *,
                 max_cliques: int | None = None, **kw) -> "MarginalWorkload":
        """All (or the first ``max_cliques``) k-way marginals of ``card``."""
        cliques = itertools.combinations(range(len(card)), k)
        if max_cliques is not None:
            cliques = itertools.islice(cliques, max_cliques)
        return cls(card, list(cliques), **kw)

    # -- static metadata ------------------------------------------------
    @property
    def m(self) -> int:
        return self._m

    @property
    def U(self) -> int:
        return self._U

    @property
    def device(self) -> torch.device:
        return self.q_clique.device

    @property
    def n_aug(self) -> int:
        """Size of the complement-augmented id space (no rows doubled)."""
        return 2 * self.m

    @property
    def dense_nbytes(self) -> int:
        """Bytes a dense ``(m, U)`` float32 table would take."""
        return 4 * self.m * self.U

    @property
    def nbytes(self) -> int:
        """Bytes of the factored representation held on the device."""
        return sum(t.numel() * t.element_size() for t in
                   (self.q_clique, self.q_offset, self.cl_dstride,
                    self.cl_card, self.cl_stride, self.cl_cells))

    # -- implicit rows --------------------------------------------------
    def cell_maps(self, cl_ids: torch.Tensor) -> torch.Tensor:
        """(t,) clique ids → (t, U) int32 marginal-cell map, recomputed
        from ``arange(U)`` by mixed-radix arithmetic (no stored table)."""
        cl_ids = torch.as_tensor(cl_ids, device=self.device).to(torch.int64)
        return self._cell_maps(self.cl_dstride[cl_ids], self.cl_card[cl_ids],
                               self.cl_stride[cl_ids])

    def _cell_maps(self, ds, cd, cs) -> torch.Tensor:
        """Cell maps from (t, kmax) domain strides, cards and cell strides
        (a contiguous range of cliques passes views, gathering nothing)."""
        u = self._u[None, :]
        cm = torch.zeros((ds.shape[0], self.U), dtype=torch.int32,
                         device=self.device)
        for j in range(self.kmax):
            cm += torch.remainder(
                torch.div(u, ds[:, j, None], rounding_mode="floor"),
                cd[:, j, None]) * cs[:, j, None]
        return cm

    def rows(self, ids: torch.Tensor) -> torch.Tensor:
        """(t,) query ids → (t, U) f32 one-hot marginal-cell rows."""
        ids = torch.as_tensor(ids, device=self.device).to(torch.int64)
        cm = self.cell_maps(self.q_clique[ids])
        return (cm == self.q_offset[ids][:, None]).to(torch.float32)

    def row(self, j) -> torch.Tensor:
        return self.rows(torch.as_tensor(j, device=self.device).reshape(1))[0]

    def winner_table(self, sel: torch.Tensor):
        """``(row table, row ids)`` the fused step reads the winners from:
        their implicit rows materialized as a (B, U) table — (1, U) for one
        winner — and ids ``arange(B)`` in ``sel``'s shape (the reference's
        `mwu_apply` route)."""
        flat = sel.reshape(-1)
        return self.rows(flat), torch.arange(
            flat.numel(), device=flat.device).reshape(sel.shape)

    # -- scoring --------------------------------------------------------
    # Each takes one probe ``v`` (U,) or a (B, U) block of probes, one a
    # lane, and then returns a leading lane axis; a block builds each cell
    # map once for all its lanes.
    def scores(self, v: torch.Tensor) -> torch.Tensor:
        """All m signed scores (the exhaustive oracle): implicit rows times
        ``v``, one (score_block, U) @ (U,) product a block of query ids —
        (score_block, U) @ (U, B) for a (B, U) block of probes, (B, m) out.

        A block of consecutive ids spans a few consecutive cliques, so
        their cell maps are built once each and a row picks its clique's
        — the very rows `rows` builds, with a fraction of the arithmetic.
        """
        B = self.score_block
        vt = v.T if v.dim() == 2 else v
        out = []
        for lo in range(0, self.m, B):
            hi = min(lo + B, self.m)
            c0 = int(np.searchsorted(self._starts, lo, side="right")) - 1
            c1 = int(np.searchsorted(self._starts, hi - 1, side="right"))
            cm = self._cell_maps(self.cl_dstride[c0:c1], self.cl_card[c0:c1],
                                 self.cl_stride[c0:c1])
            rel = self._qc64[lo:hi] - c0
            rows = (cm[rel] == self.q_offset[lo:hi, None]).to(torch.float32)
            out.append(rows @ vt)
        return torch.cat(out).T.contiguous() if v.dim() == 2 else torch.cat(out)

    def marginal_tables(self, v: torch.Tensor) -> torch.Tensor:
        """(n_cliques, max_cells) per-clique marginals of ``v`` by segment
        sums over ``clique_chunk`` cliques at a time — (B, n_cliques,
        max_cells) for a (B, U) block; pad cells stay 0."""
        v = v.to(torch.float32)
        lanes = tuple(v.shape[:-1])
        tabs = []
        for lo in range(0, self.n_cliques, self.clique_chunk):
            hi = min(lo + self.clique_chunk, self.n_cliques)
            cm = self._cell_maps(self.cl_dstride[lo:hi], self.cl_card[lo:hi],
                                 self.cl_stride[lo:hi]).to(torch.int64)
            shape = (*lanes, hi - lo, self.U)
            tab = torch.zeros((*lanes, hi - lo, self.max_cells),
                              dtype=torch.float32, device=self.device)
            tabs.append(tab.scatter_add_(-1, cm.expand(shape),
                                         v.unsqueeze(-2).expand(shape)))
        return torch.cat(tabs, -2)

    def answer_all(self, v: torch.Tensor) -> torch.Tensor:
        """All m answers ``Q v`` from the clique tables: each domain point
        is touched once a clique, not once a query."""
        return self.table_answers(self.marginal_tables(v))

    def table_answers(self, tabs: torch.Tensor) -> torch.Tensor:
        """Every query's answer read off `marginal_tables`' output: (m,)
        from (n_cliques, max_cells), (B, m) from a (B, …) block."""
        return tabs[..., self._qc64, self._qo64]

    def probe_scores(self, v: torch.Tensor) -> torch.Tensor:
        """Full (m,) signed scores for the exhaustive probe — (B, m) for a
        (B, U) block: the oracle's implicit-row product while ``m ≤
        score_block``, the segment sums past it (as the reference does)."""
        if self.m <= self.score_block:
            return self.scores(v)
        return self.answer_all(v)

    def max_err(self, h: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
        """‖Q(p − h)‖_∞ without densification (Eq. 1); (B, U) densities
        (and a shared (U,) or per-lane (B, U) ``h``) give one error a
        lane."""
        return torch.amax(torch.abs(self.answer_all(p - h)), dim=-1)

    def clique_abs_err(self, v: torch.Tensor) -> torch.Tensor:
        """(n_cliques,) max |cell| a clique, pad cells masked — the
        worst-approximated-marginal statistic of adaptive selection."""
        tabs = torch.abs(self.marginal_tables(v))
        valid = (torch.arange(self.max_cells, device=self.device)[None, :]
                 < self.cl_cells[:, None])
        return torch.amax(torch.where(valid, tabs, 0.0), dim=1)

    def clique_slice(self, c: int) -> Tuple[int, int]:
        """Host-side [start, stop) query-id range of clique ``c``."""
        return int(self._starts[c]), int(self._starts[c + 1])

    # -- densification --------------------------------------------------
    def densify(self, limit: int = DENSIFY_LIMIT_BYTES) -> np.ndarray:
        """The (m, U) float32 table in numpy; raises past ``limit`` bytes."""
        if self.dense_nbytes > limit:
            raise ValueError(f"dense table would be {self.dense_nbytes} "
                             f"bytes (> limit {limit})")
        u = np.arange(self.U, dtype=np.int64)
        qc = self.q_clique.cpu().numpy()
        qo = self.q_offset.cpu().numpy()
        ds, cd, cs = (t.cpu().numpy().astype(np.int64) for t in
                      (self.cl_dstride, self.cl_card, self.cl_stride))
        Q = np.empty((self.m, self.U), np.float32)
        for c in range(self.n_cliques):
            cm = np.zeros_like(u)
            for j in range(self.kmax):
                cm += ((u // ds[c, j]) % cd[c, j]) * cs[c, j]
            sel = qc == c
            Q[sel] = (cm[None, :] == qo[sel][:, None]).astype(np.float32)
        return Q

    def require_dense(self, context: str,
                      limit: int = DENSIFY_LIMIT_BYTES) -> torch.Tensor:
        """Dense table on the workload's device, or an error naming the
        consumer that needed one."""
        try:
            return torch.as_tensor(self.densify(limit)).to(self.device)
        except ValueError as e:
            raise ValueError(
                f"{context} requires a dense (m, U) table but "
                f"{type(self).__name__} with m={self.m}, U={self.U} "
                f"refuses to materialize it: {e}") from e

    def __repr__(self):
        return (f"MarginalWorkload(m={self.m}, U={self.U}, "
                f"n_cliques={self.n_cliques}, kmax={self.kmax})")


def as_workload(Q, device=None):
    """Coerce a dense array or tensor to a `DenseWorkload` on ``device``;
    pass `DenseWorkload` and `MarginalWorkload` through."""
    if isinstance(Q, (DenseWorkload, MarginalWorkload)):
        return Q
    return DenseWorkload(torch.as_tensor(Q, dtype=torch.float32, device=device))
