"""Public wrappers of the fused IVF probe.

`ivf_probe_stream` is kernel K4 (``csrc/ivf_probe.cu``): given the probed
cell ids on the device, it reads only those cells' valid rows from the
cell-grouped table and keeps the top-k, on the route `probe_plan` picks
(``split``: the valid rows' segments shared evenly over the card; ``narrow``:
a thread a slot), selecting in its last block when the probed cells hold at
most `CACHE_KEYS` slots. `ivf_probe_topk` is the whole probe: the centroid
top-nprobe through `mips_topk` (K1, ``plain`` mode), then K4 — the cell ids
never leave the device. One K4 launch takes at most `MAX_PROBE` cells and
`MAX_SLOTS` slots (`probe_plan`); a larger probe runs in groups of
consecutive probed cells (`probe_groups`), one launch each, merged in
probe order, so K4 takes any probe the reference takes.

`ivf_probe_stream_batch` is kernel K5 (same source): a wave of B probes
over the deduplicated union of their cells, each unique cell read once
for all lanes. `ivf_probe_topk_batch` is the whole wave probe: the
planning of `ref.batch_probe_slots` (one (B × d) @ (d × nlist) product
and sorts, as the reference plans it), then K5 — again with no host
round-trip. A wave of more than `MAX_LANES` lanes is probed in groups of
at most `MAX_LANES`, each with its own plan and its own K5, on either
device: slots lie in ascending cell order and ties rank by slot, so a
lane's top-k does not depend on the other lanes of its group. CPU tensors
run the plain versions.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ivf_probe.ref import (_pad_topk, batch_probe_slots,
                                               ivf_probe_stream_batch_ref,
                                               ivf_probe_stream_ref)
from repro_torch.kernels.mips_topk.ops import MAX_K, mips_topk

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
MAX_LANES = 16  # lanes one K5 launch scores; ivf_probe_batch_max_lanes()
ROUTES = ("split", "narrow")  # K4's routes, in the launch function's numbering
SEG = 2048            # K4 split: floats a row segment; ivf_probe_seg()
NARROW_D = 32         # K4 narrow: most d; ivf_probe_narrow_d()
NARROW_THREADS = 512  # K4 narrow: slots a block; ivf_probe_narrow_threads()
MAX_SLOTS = 2 ** 18   # K4: most nprobe · cap; ivf_probe_max_slots()
MAX_PROBE = 4096      # K4: most nprobe; ivf_probe_max_probe()
CACHE_KEYS = 8192     # K4 selects in its last block up to this many slots


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("ivf_probe")
    lib.topk_workspace_len.argtypes = [_L]
    lib.topk_workspace_len.restype = _L
    lib.ivf_probe_launch.argtypes = [_P, _I, _P, _P, _I, _I, _P, _I, _I, _I,
                                     _I, _P, _L, _P, _L, _P, _P, _P, _P]
    lib.ivf_probe_launch.restype = _I
    for fn, want in (("ivf_probe_seg", SEG), ("ivf_probe_narrow_d", NARROW_D),
                     ("ivf_probe_narrow_threads", NARROW_THREADS),
                     ("ivf_probe_max_slots", MAX_SLOTS),
                     ("ivf_probe_max_probe", MAX_PROBE),
                     ("ivf_probe_cache_keys", CACHE_KEYS)):
        getattr(lib, fn).argtypes = []
        getattr(lib, fn).restype = _I
        if getattr(lib, fn)() != want:
            raise RuntimeError(f"csrc/ivf_probe.cu {fn}() and ops disagree")
    lib.ivf_probe_batch_max_lanes.argtypes = []
    lib.ivf_probe_batch_max_lanes.restype = _I
    lib.ivf_probe_batch_plan.argtypes = [_I, _I, _I, _I, _P]
    lib.ivf_probe_batch_plan.restype = _I
    lib.ivf_probe_batch_launch.argtypes = [_P, _P, _I, _I, _P, _P, _I, _I, _P,
                                           _I, _P, _L, _P, _L, _P, _P, _P, _P]
    lib.ivf_probe_batch_launch.restype = _I
    if lib.ivf_probe_batch_max_lanes() != MAX_LANES:
        raise RuntimeError("csrc/ivf_probe.cu and ops.MAX_LANES disagree")
    return lib


def probe_plan(nprobe: int, cap: int, d: int, sms: int | None = None) -> dict:
    """K4's launch over nprobe probed cells of ``cap`` slots and rows of d
    floats, on a card of ``sms`` SMs (the current card's when None):

    - ``route``: ``narrow`` for d ≤ `NARROW_D` (a thread a slot, `blocks`
      = ⌈slots / NARROW_THREADS⌉), else ``split`` (one block an SM, rows
      cut into ``segments`` of `SEG` floats; the valid (slot, segment)
      items are shared evenly among the warps, never a grid from cap);
    - ``select``: ``last_block`` (the scoring launch's last block selects)
      when the probed cells hold at most `CACHE_KEYS` slots, else
      ``finish`` (a second launch, `topk_finish_kernel`);
    - ``scratch``: int64 words for the keys, their row ids and the segment
      partials;
      ``tickets``: the zeroed workspace words the launch raises.
    """
    slots = nprobe * cap
    if nprobe < 1 or cap < 1 or d < 1:
        raise ValueError(f"ivf_probe needs nprobe, cap, d ≥ 1; got {nprobe}, "
                         f"{cap}, {d}")
    if slots > MAX_SLOTS or nprobe > MAX_PROBE:
        raise ValueError(f"ivf_probe takes nprobe ≤ {MAX_PROBE} and nprobe·cap ≤ "
                         f"{MAX_SLOTS} slots; got {nprobe} and {slots}")
    if d <= NARROW_D:
        route, segments, blocks = "narrow", 1, -(-slots // NARROW_THREADS)
    else:
        if sms is None:
            sms = _build.sm_count()
        route, segments, blocks = "split", -(-d // SEG), sms
    parts = slots * segments if segments > 1 else 0
    return {"route": route, "segments": segments, "blocks": blocks,
            "select": "last_block" if slots <= CACHE_KEYS else "finish",
            "slots": slots, "scratch": slots + -(-slots // 2) + -(-parts // 2),
            "tickets": 1 + (slots if parts else 0)}


def wave_plan(n_slots: int, cap: int, d: int, lanes: int) -> dict:
    """K5's launch plan on the current card: splits of d and floats a
    split, rows an item (a slot's row chunk), chunks a slot, blocks a split
    (the grid is blocks × splits), items, scratch words."""
    return dict(_wave_plan(n_slots, cap, d, lanes, torch.cuda.current_device()))


@functools.lru_cache(maxsize=256)
def _wave_plan(n_slots, cap, d, lanes, device_index) -> tuple:
    out = (ctypes.c_longlong * 7)()
    if _lib().ivf_probe_batch_plan(n_slots, cap, d, lanes, out) != 0:
        raise RuntimeError("ivf_probe_batch: cannot plan the launch")
    keys = ("splits", "dsplit", "rows_per_item", "chunks", "blocks_per_split",
            "items", "scratch")
    return tuple(zip(keys, out))


def probe_groups(nprobe: int, cap: int) -> list:
    """The launches a probe of ``nprobe`` cells of ``cap`` slots takes:
    ``(first, last, slot_lo, slot_hi)`` a group — a run of consecutive
    probed cells ``probe[first:last]`` that fits `probe_plan`'s limits
    (at most `MAX_PROBE` cells and `MAX_SLOTS` slots), or, when one cell
    alone holds more than `MAX_SLOTS` slots, a range of that cell's slots.
    A probe within the limits is one group, the whole of it."""
    if cap <= MAX_SLOTS:
        step = min(MAX_PROBE, MAX_SLOTS // cap)
        return [(i, min(i + step, nprobe), 0, cap)
                for i in range(0, nprobe, step)]
    return [(i, i + 1, lo, min(lo + MAX_SLOTS, cap))
            for i in range(nprobe) for lo in range(0, cap, MAX_SLOTS)]


def ivf_probe_stream(probe: torch.Tensor, cell_rows: torch.Tensor,
                     cells: torch.Tensor, q: torch.Tensor, k: int):
    """Top-k over the probed cells → ``(ids int32 (k,), scores f32 (k,),
    n_valid int32 ())``; see `ref.ivf_probe_stream_ref` for the contract.

    A probe past `probe_plan`'s limits runs in the groups of
    `probe_groups`, one K4 call each (on either device), and their top-ks
    merge by one stable descending sort of their concatenation in group
    order: ties keep the probe-then-slot order and the −1 pads stay last.
    A group that is a slot range of one cell reads that cell's id on the
    host (a cell of more than `MAX_SLOTS` slots: one sync a range)."""
    nlist, cap, d = cell_rows.shape
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k={k} must lie in [1, {MAX_K}]")
    groups = probe_groups(probe.shape[0], cap)
    if len(groups) <= 1:
        return _probe_stream(probe, cell_rows, cells, q, k)
    outs = []
    for first, last, lo, hi in groups:
        kg = min(k, (last - first) * (hi - lo))  # no more than the group's slots
        if (lo, hi) == (0, cap):
            outs.append(_probe_stream(probe[first:last], cell_rows, cells, q, kg))
        else:
            c = int(probe[first])
            outs.append(_probe_stream(probe.new_zeros(1),
                                      cell_rows[c, lo:hi].unsqueeze(0),
                                      cells[c, lo:hi].unsqueeze(0), q, kg))
    ids, scores, n_valid = zip(*outs)
    top, pos = torch.sort(torch.cat(scores), descending=True, stable=True)
    ids, top = _pad_topk(torch.cat(ids)[pos[:k]], top[:k], k)
    return ids, top, torch.stack(n_valid).sum().to(torch.int32)


def _probe_stream(probe, cell_rows, cells, q, k):
    """One K4 call within `probe_plan`'s limits (the plain version on the
    CPU)."""
    nlist, cap, d = cell_rows.shape
    dev = _build.dispatch_device(probe, cell_rows, cells, q)
    if dev.type == "cpu":
        return ivf_probe_stream_ref(probe, cell_rows, cells, q, k)
    nprobe = probe.shape[0]
    _build.require("probe", probe, torch.int32, shape=(nprobe,))
    _build.require("cell_rows", cell_rows, torch.float32)
    _build.require("cells", cells, torch.int32, shape=(nlist, cap))
    _build.require("q", q, torch.float32, shape=(d,))
    lib = _lib()
    p = probe_plan(nprobe, cap, d, _build.sm_count(dev))
    scratch = torch.empty(p["scratch"], dtype=torch.int64, device=dev)
    ws = _build.workspace(dev, lib.topk_workspace_len(p["tickets"]))
    ids = torch.empty(k, dtype=torch.int32, device=dev)
    scores = torch.empty(k, dtype=torch.float32, device=dev)
    n_valid = torch.empty((), dtype=torch.int32, device=dev)
    err = lib.ivf_probe_launch(probe.data_ptr(), nprobe, cell_rows.data_ptr(),
                               cells.data_ptr(), cap, d, q.data_ptr(), k,
                               ROUTES.index(p["route"]), p["blocks"],
                               int(p["select"] == "last_block"),
                               scratch.data_ptr(), scratch.numel(),
                               ws.data_ptr(), ws.numel(),
                               ids.data_ptr(), scores.data_ptr(),
                               n_valid.data_ptr(), _build.stream_ptr(dev))
    _build.check(lib, err, "ivf_probe")
    ivf_probe_stream.launches += 1
    return ids, scores, n_valid


ivf_probe_stream.launches = 0


def ivf_probe_topk(cents: torch.Tensor, cell_rows: torch.Tensor,
                   cells: torch.Tensor, q: torch.Tensor, k: int, nprobe: int):
    """Fused IVF probe: top-k inner products over the ``nprobe`` cells
    whose centroids score highest against ``q`` (signed, ties to the lower
    cell id) → ``(ids, scores, n_valid)``."""
    probe, _ = mips_topk(cents, q, nprobe, mode="plain")
    return ivf_probe_stream(probe, cell_rows, cells, q, k)


def ivf_probe_stream_batch(slots: torch.Tensor, member: torch.Tensor,
                           cell_rows: torch.Tensor, cells: torch.Tensor,
                           Vb: torch.Tensor, k: int):
    """K5: per-lane top-k over the planned slots → ``(ids int32 (B, k),
    scores f32 (B, k), n_valid int32 (B,))``; see
    `ref.ivf_probe_stream_batch_ref` for the contract (slot-order ties)."""
    nlist, cap, d = cell_rows.shape
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k={k} must lie in [1, {MAX_K}]")
    dev = _build.dispatch_device(slots, member, cell_rows, cells, Vb)
    if dev.type == "cpu":
        return ivf_probe_stream_batch_ref(slots, member, cell_rows, cells, Vb, k)
    B = Vb.shape[0]
    if not 1 <= B <= MAX_LANES:
        raise ValueError(f"the batched probe kernel scores 1..{MAX_LANES} "
                         f"lanes a launch; got {B}")
    n_slots = slots.shape[0]
    _build.require("slots", slots, torch.int32, shape=(n_slots,))
    _build.require("member", member, torch.float32, shape=(n_slots, B))
    _build.require("cell_rows", cell_rows, torch.float32)
    _build.require("cells", cells, torch.int32, shape=(nlist, cap))
    _build.require("Vb", Vb, torch.float32, shape=(B, d))
    lib = _lib()
    p = wave_plan(n_slots, cap, d, B)
    scratch = torch.empty(p["scratch"], dtype=torch.int64, device=dev)
    ws = _build.workspace(dev, lib.topk_workspace_len(p["items"] + p["splits"]))
    ids = torch.empty((B, k), dtype=torch.int32, device=dev)
    scores = torch.empty((B, k), dtype=torch.float32, device=dev)
    n_valid = torch.empty(B, dtype=torch.int32, device=dev)
    err = lib.ivf_probe_batch_launch(
        slots.data_ptr(), member.data_ptr(), n_slots, B, cell_rows.data_ptr(),
        cells.data_ptr(), cap, d, Vb.data_ptr(), k, scratch.data_ptr(),
        scratch.numel(), ws.data_ptr(), ws.numel(), ids.data_ptr(),
        scores.data_ptr(), n_valid.data_ptr(), _build.stream_ptr(dev))
    _build.check(lib, err, "ivf_probe_batch")
    ivf_probe_stream_batch.launches += 1
    return ids, scores, n_valid


ivf_probe_stream_batch.launches = 0


def ivf_probe_topk_batch(cents: torch.Tensor, cell_rows: torch.Tensor,
                         cells: torch.Tensor, Vb: torch.Tensor, k: int,
                         nprobe: int):
    """Wave IVF probe of B probe vectors ``Vb`` (B, d): plan the lanes'
    top-``nprobe`` cells (signed, ties to the lower cell id), then K5 →
    ``(ids (B, k), scores (B, k), n_valid (B,))``. Any B: groups of at
    most `MAX_LANES` lanes are planned and probed one after another."""
    outs = []
    for b0 in range(0, Vb.shape[0], MAX_LANES):
        Vg = Vb[b0:b0 + MAX_LANES]
        slots, member, _ = batch_probe_slots(cents, Vg, nprobe)
        outs.append(ivf_probe_stream_batch(slots, member, cell_rows, cells,
                                           Vg, k))
    if len(outs) == 1:
        return outs[0]
    return tuple(torch.cat(parts) for parts in zip(*outs))
