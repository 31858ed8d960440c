#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of Fast-MWEM on one NVIDIA card.

    python3 chip_smoke.py [--seed 0] [--T 1000] [--m-log2 16] [--n-records 100000]

1. Builds the port's CUDA kernels from ``src/repro_torch/csrc`` (one nvcc
   per source, in parallel) into ``build/repro_torch/``.
2. Holds every kernel against its plain PyTorch version on the card, at
   ragged edge shapes (a row count that is no tile multiple, fewer valid
   IVF candidates than k, exact ties).
3. Checks the whole release loop on a small input: the card's run and the
   CPU run of the plain versions, fed the same draws, must select the same
   queries and release the same histogram.
4. Runs the main path through `run_mwem` at the `fastmwem-synth` domain
   (U = 2**14) with m = 2**16 base queries, T = 1000, (ε, δ) = (1, 1e-3),
   n = 100000 records: exhaustive MWEM, Fast-MWEM over the flat index and
   Fast-MWEM over the IVF index. Kernel launch counts are zeroed just
   before each run and read just after it. Each release must beat the
   uniform histogram. (With n = 500 records, `--n-records 500`, the
   sensitivity 1/n makes the per-step EM scores too flat to pick an
   informative query among 2**17 on this domain, and no run beats the
   uniform baseline; nor does the JAX reference at U = 2**14, T = 1000
   with fewer queries, `scripts/reference_n_records.py`.)
5. Profiles 51 iterations of each mode (`torch.profiler`, CUDA activity).
   From that one trace it takes the window between the ends of the first
   and the last `mwem_step` kernel — 50 whole iterations, without the
   set-up and the final error evaluation — and reports the device's busy
   share of that window, beside the same run's CUDA-event iteration time.
6. The B-lane wave batch: holds K5 (the wave IVF probe) and K2/K3 on lane
   grids to their plain versions at edge shapes (1, 3, 8 and 16 lanes, a cell
   capacity that is no multiple of 8, lanes that share, overlap or split
   their cells, fewer valid candidates than k, exact ties); checks a small
   `run_mwem_batch` on the card against the CPU's and each card lane
   against the card's single-lane `run_mwem`; then runs B = 8 lanes at the
   main path's size in exact and flat mode (shared histogram) and IVF mode
   (one histogram a lane, reusing the IVF index above), and profiles 51
   iterations of the IVF wave as in step 5.
7. Holds every kernel against its plain version again at the shapes the
   main paths gave it — K1 in `aug` mode over Q (the flat probe) and in
   `plain` mode over the IVF centroids (the IVF probe's first step), K5,
   K2 and K3 at the wave's shapes — and times each with CUDA events.

It needs one CUDA device and exits non-zero, printing no result, without
one. The last lines are the card, the per-kernel JSON line and the result.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

U = 2 ** 14  # fastmwem-synth's domain, src/repro/configs/fastmwem_synth.py:17
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (NVIDIA data sheet)
F32_FLOP_PER_S = 67e12      # H100 SXM float32 outside the tensor cores
LANES = 8  # the serving tier's wave, src/repro/serve/release_service.py:218
KERNELS = ("mips_topk", "ivf_probe", "mwem_step", "gather_score",
           "ivf_probe_batch", "mwem_step_batch", "gather_score_batch")
REPLACES = {
    "mips_topk": "src/repro/kernels/mips_topk/mips_topk.py:97",
    "ivf_probe": "src/repro/kernels/ivf_probe/ivf_probe.py:120",
    "mwem_step": "src/repro/kernels/mwem_step/mwem_step.py:103",
    "gather_score": "src/repro/kernels/mwem_step/mwem_step.py:139",
    "ivf_probe_batch": "src/repro/kernels/ivf_probe/ivf_probe.py:215",
    "mwem_step_batch": "src/repro/kernels/mwem_step/mwem_step.py:103",
    "gather_score_batch": "src/repro/kernels/mwem_step/mwem_step.py:139",
}
SOURCES = {
    "mips_topk": "src/repro_torch/csrc/mips_topk.cu",
    "ivf_probe": "src/repro_torch/csrc/ivf_probe.cu",
    "mwem_step": "src/repro_torch/csrc/mwem_step.cu",
    "gather_score": "src/repro_torch/csrc/mwem_step.cu",
    "ivf_probe_batch": "src/repro_torch/csrc/ivf_probe.cu",
    "mwem_step_batch": "src/repro_torch/csrc/mwem_step.cu",
    "gather_score_batch": "src/repro_torch/csrc/mwem_step.cu",
}


def log(msg: str) -> None:
    print(msg, flush=True)


def f32_tol(d: int, mag: float) -> float:
    """Tolerance between two f32 dot products of length d summed in
    different orders: 8 standard deviations of a random walk of d roundings
    of relative size 2**-24, on the magnitude ``mag`` = Σ|x_i·y_i|."""
    return 8.0 * math.sqrt(d) * 2.0 ** -24 * mag + 1e-30


def same_topk(ids_k, s_k, ids_r, s_r, tol: float) -> tuple[bool, float]:
    """Scores agree within ``tol`` position by position; ids agree except
    where the reference's score is within 2·tol of another score (a tie
    up to float noise). Returns (ok, max |Δscore| over finite entries)."""
    s_k, s_r = s_k.double().cpu(), s_r.double().cpu()
    ids_k, ids_r = ids_k.cpu(), ids_r.cpu()
    fin = s_r.isfinite()
    if not bool((s_k.isfinite() == fin).all()):
        return False, math.inf
    err = float((s_k[fin] - s_r[fin]).abs().max()) if bool(fin.any()) else 0.0
    ok = err <= tol and bool((ids_k[~fin] == ids_r[~fin]).all())
    for i in (ids_k != ids_r).nonzero().flatten().tolist():
        if not fin[i]:
            continue
        gaps = (s_r[fin] - s_r[i]).abs()
        if int((gaps <= 2 * tol).sum()) < 2:  # no near-tie explains it
            ok = False
    return ok, err


def time_ms(fn, reps: int = 20) -> float:
    """Median device time of one call of ``fn``, by CUDA events around
    replays of a CUDA graph that captured the call — so the host's Python
    overhead between launches is not counted."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    t_mem, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S
    return 1e3 * max(t_mem, t_ops), "bytes" if t_mem >= t_ops else "operations"


class NumpyDraws:
    """The draw protocol from numpy, one generator per (iteration, draw),
    so a CPU run and a CUDA run are fed the very same numbers."""

    def __init__(self, seed: int):
        self.seed = seed

    def _rng(self, t, tag):
        return np.random.default_rng([self.seed, t, tag])

    def _out(self, x, device, dtype):
        import torch

        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    def topk_gumbel(self, t, k, device):
        import torch

        return self._out(self._rng(t, 0).gumbel(size=k).astype(np.float32),
                         device, torch.float32)

    def tail_count(self, t, trials, p):
        import torch

        c = self._rng(t, 1).binomial(trials, float(p))
        return torch.tensor(int(c), dtype=torch.int64, device=p.device)

    def tail_randint(self, t, size, high, device):
        import torch

        return self._out(self._rng(t, 2).integers(0, high, size), device,
                         torch.int64)

    def tail_uniform(self, t, size, device):
        import torch

        return self._out(self._rng(t, 3).random(size, np.float32), device,
                         torch.float32)

    def exhaustive_gumbel(self, t, n, device):
        import torch

        return self._out(self._rng(t, 4).gumbel(size=n).astype(np.float32),
                         device, torch.float32)

    def fallback_gumbel(self, t, n, device):
        import torch

        return self._out(self._rng(t, 5).gumbel(size=n).astype(np.float32),
                         device, torch.float32)

    def laplace(self, t, device):
        import torch

        return self._out(np.float32(self._rng(t, 6).laplace()), device,
                         torch.float32)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def reset_counts(ops) -> None:
    for fn in ops.values():
        fn.launches = 0


def profile_window(run) -> tuple:
    """``run()``'s result and the device busy share of its iterations
    after the first (T of them, 51 here, give a window of 50), from one
    `torch.profiler` trace: the window runs from the end of iteration 0's
    `mwem_step` kernel to the end of the last one, so set-up and the final
    error evaluation lie outside it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        res = run()
        torch.cuda.synchronize()
    gpu = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    step_ends = sorted(e.time_range.end for e in gpu
                       if "mwem_step_kernel" in e.name)
    w0, w1, n_it = step_ends[0], step_ends[-1], len(step_ends) - 1
    inside = [e for e in gpu if e.time_range.start >= w0
              and e.time_range.end <= w1]
    busy = {}
    for e in inside:
        busy[e.name] = busy.get(e.name, 0.0) + e.time_range.elapsed_us()
    window_ms = (w1 - w0) / 1e3 / n_it
    busy_ms = sum(busy.values()) / 1e3 / n_it
    top = sorted(busy.items(), key=lambda kv: -kv[1])[:6]
    return res, {"iterations": n_it, "device_busy_ms_per_iter": busy_ms,
                 "window_ms_per_iter": window_ms,
                 "busy_share": busy_ms / window_ms,
                 "device_ops_per_iter": len(inside) / n_it,
                 "top": [[name[:60], us / 1e3 / n_it] for name, us in top]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--T", type=int, default=1000)
    ap.add_argument("--m-log2", type=int, default=16)
    ap.add_argument("--n-records", type=int, default=100_000)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from repro_torch.core import (LaneDraws, MWEMConfig, PrivacyLedger,
                                  TorchDraws, release_cost, run_mwem,
                                  run_mwem_batch)
    from repro_torch.core.queries import (gaussian_histogram, max_error,
                                          random_binary_queries)
    from repro_torch.kernels import _build
    from repro_torch.kernels.ivf_probe import (batch_probe_slots,
                                               ivf_probe_stream,
                                               ivf_probe_stream_batch,
                                               ivf_probe_stream_batch_ref,
                                               ivf_probe_stream_ref)
    from repro_torch.kernels.mips_topk import mips_topk, mips_topk_ref
    from repro_torch.kernels.mwem_step import (gather_score,
                                               gather_score_batch,
                                               gather_score_batch_ref,
                                               gather_score_ref, mwem_step,
                                               mwem_step_batch,
                                               mwem_step_batch_ref,
                                               mwem_step_ref)
    from repro_torch.mips import FlatAbsIndex, IVFIndex, augment_complement

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    ops = {"mips_topk": mips_topk, "ivf_probe": ivf_probe_stream,
           "mwem_step": mwem_step, "gather_score": gather_score,
           "ivf_probe_batch": ivf_probe_stream_batch,
           "mwem_step_batch": mwem_step_batch,
           "gather_score_batch": gather_score_batch}
    failures: list[str] = []

    def expect(cond: bool, what: str) -> None:
        if not cond:
            failures.append(what)
            log(f"FAIL: {what}")

    card = card_line()
    log(f"card: {card}")
    t0 = time.perf_counter()
    libs = _build.build_all()
    log(f"build: {time.perf_counter() - t0:.1f} s ({len(libs)} libraries)")
    log(json.dumps({"kernels": list(KERNELS)}))

    # ---------------------------------------------- ragged edge shapes
    g = torch.Generator(device=dev).manual_seed(args.seed)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    for n, d, k in ((1000, 100, 37), (257, 64, 256), (5, 3, 5)):
        V, q = randn(n, d), randn(d)
        for mode in ("plain", "abs", "aug"):
            kk = min(k, 2 * n if mode == "aug" else n)
            got, want = mips_topk(V, q, kk, mode), mips_topk_ref(V, q, kk, mode)
            ok, err = same_topk(*got, *want, f32_tol(d, float((V.abs() @ q.abs()).max())))
            expect(ok, f"mips_topk {mode} n={n} d={d} k={kk}: max err {err}")
    Vi = torch.randint(-2, 3, (300, 8), generator=g, device=dev).float()
    qi = torch.randint(-2, 3, (8,), generator=g, device=dev).float()
    for mode in ("plain", "abs", "aug"):
        got, want = mips_topk(Vi, qi, 40, mode), mips_topk_ref(Vi, qi, 40, mode)
        expect(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
               f"mips_topk {mode}: exact ties must follow the plain order")
    nlist, cap, d = 13, 24, 40
    rows = randn(nlist, cap, d)
    ids = torch.arange(nlist * cap, device=dev, dtype=torch.int32).reshape(nlist, cap)
    ids[:, 7:] = -1  # few valid slots per cell
    rows[:, 7:] = 0
    q = randn(d)
    probe = torch.tensor([4, 0, 12], dtype=torch.int32, device=dev)
    for k in (5, 21, 40):
        got, want = ivf_probe_stream(probe, rows, ids, q, k), \
            ivf_probe_stream_ref(probe, rows, ids, q, k)
        ok, err = same_topk(got[0], got[1], want[0], want[1],
                            f32_tol(d, float((rows.abs() @ q.abs()).max())))
        expect(ok and int(got[2]) == int(want[2]),
               f"ivf_probe k={k}: max err {err}, n_valid {int(got[2])}/{int(want[2])}")
    rows_i = torch.randint(-2, 3, (nlist, cap, 8), generator=g, device=dev).float()
    ids_i = torch.arange(nlist * cap, device=dev, dtype=torch.int32).reshape(nlist, cap)
    got = ivf_probe_stream(probe, rows_i, ids_i, qi, 30)
    want = ivf_probe_stream_ref(probe, rows_i, ids_i, qi, 30)
    expect(all(torch.equal(a, b) for a, b in zip(got, want)),
           "ivf_probe: exact ties must follow probe then slot order")
    for u in (1000, 4096, 16384):
        Qs = (torch.rand(7, u, generator=g, device=dev) < 0.3).float()
        lw = randn(u)
        lw = lw - lw.max()
        p = torch.softmax(lw, 0)
        ps, h = torch.rand(u, generator=g, device=dev), torch.softmax(randn(u), 0)
        for rule in ("paper", "signed", "hardt"):
            sel = torch.tensor(5, device=dev)
            noise = torch.tensor(0.003, device=dev)
            got = mwem_step(lw, p, ps, Qs, sel, h, noise, rule=rule, eta=0.3)
            want = mwem_step_ref(lw, p, ps, Qs, sel, h, noise, rule=rule, eta=0.3)
            ok = all(torch.allclose(a, b, rtol=1e-4, atol=1e-7)
                     for a, b in zip(got, want))
            expect(ok, f"mwem_step u={u} {rule}")
        aug = torch.randint(0, 14, (50,), generator=g, device=dev)
        act = torch.rand(50, generator=g, device=dev) < 0.5
        v = randn(u) * 1e-3
        err = float((gather_score(Qs, v, aug, act)
                     - gather_score_ref(Qs, v, aug, act)).abs().max())
        expect(err <= f32_tol(u, float((Qs @ v.abs()).max())),
               f"gather_score u={u}: max err {err}")
    torch.cuda.synchronize()
    log(f"edge shapes: {'ok' if not failures else 'FAILED'}")

    # --------------------------------------- small release, card vs CPU
    rng = np.random.default_rng(args.seed)
    Qs_np, hs_np = random_binary_queries(rng, 512, 256), gaussian_histogram(rng, 500, 256)
    for kind in ("exact", "flat", "ivf"):
        cfg = MWEMConfig(T=30, mode="exact" if kind == "exact" else "fast",
                         n_records=500)
        pair = []
        for where in (dev, torch.device("cpu")):
            index = None
            if kind == "flat":
                index = FlatAbsIndex(Qs_np, device=where)
            elif kind == "ivf":
                index = IVFIndex(augment_complement(Qs_np), seed=0, device=where)
            pair.append(run_mwem(Qs_np, hs_np, cfg, NumpyDraws(args.seed + 1),
                                 index=index, device=where))
        a, b = pair
        same = (a.selected == b.selected and a.n_scored == b.n_scored
                and torch.allclose(a.p_hat.cpu(), b.p_hat, rtol=1e-4, atol=1e-7))
        expect(same, f"small {kind} release: card and CPU runs differ")
    log(f"small releases: {'ok' if not failures else 'FAILED'}")

    # ------------------------------ wave kernels at ragged edge shapes
    def probe_case(lanes, nlist, cap, d, n_ok, nprobe, ks, how, integer=False):
        """K5 against its plain version on one planned wave: ``how`` says
        whether the lanes probe the same cells, disjoint ones or any."""
        if integer:
            rows_ = torch.randint(-2, 3, (nlist, cap, d), generator=g,
                                  device=dev).float()
        else:
            rows_ = randn(nlist, cap, d)
        ids_ = torch.arange(nlist * cap, device=dev,
                            dtype=torch.int32).reshape(nlist, cap)
        ids_[:, n_ok:] = -1
        rows_[:, n_ok:] = 0
        if how == "disjoint":  # lane b's cells are b·nprobe .. (b+1)·nprobe-1
            cents_ = torch.zeros(nlist, d, device=dev)
            cents_[:, :nlist] = torch.eye(nlist, device=dev)
            qb = torch.zeros(lanes, d, device=dev)
            for b in range(lanes):
                qb[b, b * nprobe:(b + 1) * nprobe] = torch.arange(
                    nprobe, 0, -1, device=dev, dtype=torch.float32)
            qb = qb + 1e-3 * randn(lanes, d)
        else:
            cents_ = randn(nlist, d)
            qb = (torch.randint(-2, 3, (lanes, d), generator=g, device=dev).float()
                  if integer else randn(lanes, d))
            if how == "same":
                qb = qb[:1].expand(lanes, d).contiguous()
        slots, member, probe = batch_probe_slots(cents_, qb, nprobe)
        n_members = member.sum(0)
        if how == "same":
            expect(bool((member.sum(1) % lanes == 0).all()), "same cells")
        if how == "disjoint":
            expect(int((member.sum(1) > 0).sum()) == lanes * nprobe,
                   "disjoint cells")
        expect(bool((n_members == nprobe).all()), "each lane probes nprobe")
        tol = f32_tol(d, float((rows_.abs().reshape(-1, d) @ qb.abs().T).max()))
        for k in ks:
            got = ivf_probe_stream_batch(slots, member, rows_, ids_, qb, k)
            want = ivf_probe_stream_batch_ref(slots, member, rows_, ids_, qb, k)
            if integer:
                ok = all(torch.equal(a, b) for a, b in zip(got, want))
                err = 0.0
            else:
                ok, err = True, 0.0
                for b in range(lanes):
                    ok_b, err_b = same_topk(got[0][b], got[1][b], want[0][b],
                                            want[1][b], tol)
                    ok, err = ok and ok_b, max(err, err_b)
                ok = ok and torch.equal(got[2], want[2])
            expect(ok, f"ivf_probe_batch B={lanes} cap={cap} d={d} {how} "
                   f"k={k}{' ties' if integer else ''}: max err {err}")

    for lanes in (1, 3, 8):
        probe_case(lanes, 29, 13, 40, 7, 3, (5, 21, 100), "any")
        probe_case(lanes, 29, 13, 40, 13, 3, (16,), "same")
        probe_case(lanes, 29, 13, 40, 13, 3, (16,), "disjoint")
        probe_case(lanes, 13, 24, 8, 24, 3, (30,), "any", integer=True)
    probe_case(8, 20, 150, 301, 140, 4, (200,), "any")  # d with no float4 path
    probe_case(16, 60, 70, 64, 70, 3, (90,), "any")     # the widest wave
    for u in (1000, 16384):
        Qs = (torch.rand(9, u, generator=g, device=dev) < 0.3).float()
        lw = randn(LANES, u)
        lw = lw - lw.amax(1, keepdim=True)
        p = torch.softmax(lw, 1)
        ps = torch.rand(LANES, u, generator=g, device=dev)
        hb = torch.softmax(randn(LANES, u), 1)
        sel = torch.randint(0, 9, (LANES,), generator=g, device=dev)
        noise = 1e-3 * randn(LANES)
        for rule in ("paper", "signed", "hardt"):
            for hh in (hb[0], hb):
                got = mwem_step_batch(lw, p, ps, Qs, sel, hh, noise, rule=rule,
                                      eta=0.3)
                want = mwem_step_batch_ref(lw, p, ps, Qs, sel, hh, noise,
                                           rule=rule, eta=0.3)
                ok = all(torch.allclose(a, b, rtol=1e-4, atol=1e-7)
                         for a, b in zip(got, want))
                for b in range(LANES):  # each block is a single-lane launch
                    one = mwem_step(lw[b], p[b], ps[b], Qs, sel[b],
                                    hh if hh.dim() == 1 else hh[b], noise[b],
                                    rule=rule, eta=0.3)
                    ok = ok and all(torch.equal(a[b], c) for a, c in zip(got, one))
                expect(ok, f"mwem_step_batch u={u} {rule} h{tuple(hh.shape)}")
        aug = torch.randint(0, 18, (LANES, 50), generator=g, device=dev)
        act = torch.rand(LANES, 50, generator=g, device=dev) < 0.5
        V = randn(LANES, u) * 1e-3
        got = gather_score_batch(Qs, V, aug, act)
        err = float((got - gather_score_batch_ref(Qs, V, aug, act)).abs().max())
        expect(err <= f32_tol(u, float((Qs @ V.abs().T).max()))
               and float(got[~act].abs().sum()) == 0.0,
               f"gather_score_batch u={u}: max err {err}")
    torch.cuda.synchronize()
    log(f"wave edge shapes: {'ok' if not failures else 'FAILED'}")

    # ---------------------------------------- small wave, card vs CPU
    rng_b = np.random.default_rng([args.seed, 1])  # leaves `rng` to the main path
    hb_np = np.stack([gaussian_histogram(rng_b, 500, 256) for _ in range(3)])
    for kind in ("exact", "flat", "ivf"):
        cfg = MWEMConfig(T=30, mode="exact" if kind == "exact" else "fast",
                         n_records=500)
        pair = []  # (index, h, result): the card's run, then the CPU's
        for where in (dev, torch.device("cpu")):
            index = None
            if kind == "flat":
                index = FlatAbsIndex(Qs_np, device=where)
            elif kind == "ivf":
                index = IVFIndex(augment_complement(Qs_np), seed=0, device=where)
            hh = hb_np if kind == "ivf" else hs_np
            lanes = [NumpyDraws(args.seed + 20 + b) for b in range(3)]
            pair.append((index, hh, run_mwem_batch(
                Qs_np, hh, cfg, lanes, index=index, device=where)))
        a, b = pair[0][2], pair[1][2]
        same = (np.array_equal(a.selected, b.selected)
                and np.array_equal(a.n_scored, b.n_scored)
                and torch.allclose(a.p_hat.cpu(), b.p_hat, rtol=1e-4, atol=1e-7))
        expect(same, f"small {kind} wave: card and CPU runs differ")
        index, hh, _ = pair[0]
        for lane, res in enumerate(a.unbatch()):
            one = run_mwem(Qs_np, hh if hh.ndim == 1 else hh[lane], cfg,
                           NumpyDraws(args.seed + 20 + lane), index=index)
            expect(res.selected == one.selected
                   and res.n_scored == one.n_scored,
                   f"small {kind} wave: lane {lane} differs from its "
                   f"single-lane run")
    log(f"small waves: {'ok' if not failures else 'FAILED'}")

    # ---------------------------------------------------- main path
    m, T, n_rec = 2 ** args.m_log2, args.T, args.n_records
    t0 = time.perf_counter()
    Q_np = random_binary_queries(rng, m, U)
    h_np = gaussian_histogram(rng, n_rec, U)
    Q = torch.as_tensor(Q_np).to(dev)
    h = torch.as_tensor(h_np).to(dev)
    uniform = float(max_error(Q, h, torch.full((U,), 1.0 / U, device=dev)))
    log(f"data: m={m} U={U} on the card in {time.perf_counter() - t0:.1f} s; "
        f"uniform-baseline error {uniform:.6f}")
    t0 = time.perf_counter()
    ivf = IVFIndex(augment_complement(Q_np), seed=args.seed, device=dev)
    torch.cuda.synchronize()
    log(f"ivf build: {time.perf_counter() - t0:.1f} s (nlist={ivf.nlist}, "
        f"cap={ivf.cap}, nprobe={ivf.nprobe})")
    del Q_np
    flat = FlatAbsIndex(Q, device=dev)
    launches = {name: 0 for name in KERNELS}
    run_counts = {}
    expected = {"exact": {"mwem_step"},
                "flat": {"mips_topk", "gather_score", "mwem_step"},
                "ivf": {"mips_topk", "ivf_probe", "gather_score", "mwem_step"}}
    runs = {}
    for kind, index in (("exact", None), ("flat", flat), ("ivf", ivf)):
        cfg = MWEMConfig(eps=1.0, delta=1e-3, T=T, n_records=n_rec,
                         mode="exact" if kind == "exact" else "fast")
        draws = TorchDraws.seeded(args.seed + 1, dev)
        torch.cuda.synchronize()
        reset_counts(ops)
        t0 = time.perf_counter()
        res = run_mwem(Q, h, cfg, draws, index=index)
        wall = time.perf_counter() - t0
        counts = {name: fn.launches for name, fn in ops.items()}
        run_counts[kind] = counts
        for name, c in counts.items():
            launches[name] += c
        preview = PrivacyLedger().preview(*release_cost(cfg, m, U, index))
        composed = res.ledger.composed()
        mean_scored = float(np.mean(res.n_scored))
        runs[kind] = res
        log(json.dumps({"run": kind, "final_error": res.final_error,
                        "uniform_error": uniform, "mean_n_scored": mean_scored,
                        "overflow_count": res.overflow_count,
                        "eps_delta": composed, "preview": preview,
                        "wall_s": wall,
                        "mean_iter_ms": 1e3 * float(np.mean(res.iter_seconds)),
                        "launches": counts}))
        expect(math.isfinite(res.final_error) and res.final_error < uniform,
               f"{kind}: error {res.final_error} not below uniform {uniform}")
        expect(bool(torch.isfinite(res.p_hat).all())
               and tuple(res.p_hat.shape) == (U,), f"{kind}: p_hat malformed")
        expect(composed == preview, f"{kind}: ledger {composed} != {preview}")
        for name in expected[kind]:
            expect(counts[name] > 0, f"{kind}: kernel {name} never launched")
        if kind == "ivf":
            expect(mean_scored < m / 4, f"ivf: mean n_scored {mean_scored} "
                   f"not well under m={m}")

    # ------------------- device busy share of an iteration, by profiler
    for kind, index in (("exact", None), ("flat", flat), ("ivf", ivf)):
        cfg = MWEMConfig(T=51, n_records=n_rec,
                         mode="exact" if kind == "exact" else "fast")
        res, prof = profile_window(
            lambda: run_mwem(Q, h, cfg, TorchDraws.seeded(args.seed + 2, dev),
                             index=index))
        log(json.dumps({"profile": kind, **prof, "event_iter_ms":
                        1e3 * float(np.mean(res.iter_seconds[1:]))}))

    # ------------------------------------------ main wave path, B lanes
    hb_main = torch.as_tensor(np.stack([
        gaussian_histogram(np.random.default_rng([args.seed, 2, b]), n_rec, U)
        for b in range(LANES)])).to(dev)
    uniform_b = max_error(Q, hb_main, torch.full((LANES, U), 1.0 / U, device=dev))
    wave_counts = {}
    expected_b = {"exact": {"mwem_step_batch"},
                  "flat": {"gather_score_batch", "mwem_step_batch"},
                  "ivf": {"ivf_probe_batch", "gather_score_batch",
                          "mwem_step_batch"}}
    waves = {}
    for kind, index in (("exact", None), ("flat", flat), ("ivf", ivf)):
        cfg = MWEMConfig(eps=1.0, delta=1e-3, T=T, n_records=n_rec,
                         mode="exact" if kind == "exact" else "fast")
        hh = hb_main if kind == "ivf" else h
        base = uniform_b if kind == "ivf" else torch.full((LANES,), uniform,
                                                          device=dev)
        draws = LaneDraws.seeded([args.seed + 100 + b for b in range(LANES)], dev)
        ledgers = [PrivacyLedger() for _ in range(LANES)]
        torch.cuda.synchronize()
        reset_counts(ops)
        t0 = time.perf_counter()
        res = run_mwem_batch(Q, hh, cfg, draws, index=index, ledgers=ledgers)
        wall = time.perf_counter() - t0
        counts = {name: fn.launches for name, fn in ops.items()}
        wave_counts[kind] = counts
        for name, c in counts.items():
            launches[name] += c
        waves[kind] = res
        preview = PrivacyLedger().preview(*release_cost(cfg, m, U, index))
        errs = res.final_errors
        log(json.dumps({"wave": kind, "lanes": LANES,
                        "final_errors": errs.tolist(),
                        "uniform_errors": base.tolist(),
                        "mean_n_scored": float(res.n_scored.mean()),
                        "overflow_counts": res.overflow_counts.tolist(),
                        "distinct_selections": len({tuple(r) for r in res.selected}),
                        "preview": preview, "wall_s": wall,
                        "device_s": res.total_seconds,
                        "ms_per_iter": 1e3 * res.total_seconds / T,
                        "launches": counts}))
        expect(bool(np.isfinite(errs).all()) and bool((errs < base.cpu().numpy()).all()),
               f"wave {kind}: errors {errs} not all below uniform {base.tolist()}")
        expect(bool(torch.isfinite(res.p_hat).all())
               and tuple(res.p_hat.shape) == (LANES, U), f"wave {kind}: p_hat malformed")
        expect(all(led.composed() == preview for led in ledgers),
               f"wave {kind}: a lane's ledger differs from {preview}")
        expect(len({tuple(r) for r in res.selected}) > 1,
               f"wave {kind}: every lane selected the same queries")
        for name in expected_b[kind]:
            expect(counts[name] > 0, f"wave {kind}: kernel {name} never launched")

    T_prof = 51
    cfg = MWEMConfig(T=T_prof, n_records=n_rec, mode="fast")
    res, prof = profile_window(lambda: run_mwem_batch(
        Q, hb_main, cfg, LaneDraws.seeded(range(args.seed + 200,
                                                args.seed + 200 + LANES), dev),
        index=ivf))
    log(json.dumps({"profile": "wave ivf", "lanes": LANES, **prof,
                    "event_iter_ms": 1e3 * res.total_seconds / T_prof}))

    # ------------------------------- kernels at the main path's shapes
    p = torch.softmax(torch.zeros(U, device=dev), 0)
    v = h - runs["flat"].p_hat
    k = math.ceil(math.sqrt(m))
    tail_cap = 4 * math.ceil(math.sqrt(2 * m))
    rows_gen = torch.Generator(device=dev).manual_seed(args.seed + 7)
    aug = torch.randint(0, 2 * m, (tail_cap,), generator=rows_gen, device=dev)
    active = torch.rand(tail_cap, generator=rows_gen, device=dev) < 0.25
    probe, _ = mips_topk(ivf._cents, v, ivf.nprobe, "plain")
    n_valid = int(ivf_probe_stream(probe, ivf._cell_rows, ivf._cells8, v, k)[2])
    sel = torch.tensor(runs["flat"].selected[-1], device=dev)
    noise = torch.tensor(1e-3, device=dev)
    lw0 = torch.zeros(U, device=dev)
    ps0 = runs["flat"].p_hat.clone()
    vq = float((Q.abs() @ v.abs()).max())
    n_act = int(active.sum())
    cents = ivf._cents
    # (row, wrapper, mode, launches, kernel call, plain call, tolerance,
    #  bytes, f32 operations). K1 runs in `aug` mode only on the flat run
    # and in `plain` mode only on the IVF run, so each mode's launches are
    # that run's count.
    cases = [
        ("mips_topk", "mips_topk", "aug", run_counts["flat"]["mips_topk"],
         lambda: mips_topk(Q, v, k, "aug"),
         lambda: mips_topk_ref(Q, v, k, "aug"),
         f32_tol(U, vq), 4.0 * m * U + 4 * U + 8 * k, 2.0 * m * U),
        ("mips_topk:plain", "mips_topk", "plain", run_counts["ivf"]["mips_topk"],
         lambda: mips_topk(cents, v, ivf.nprobe, "plain"),
         lambda: mips_topk_ref(cents, v, ivf.nprobe, "plain"),
         f32_tol(U, float((cents.abs() @ v.abs()).max())),
         4.0 * ivf.nlist * U + 4 * U + 8 * ivf.nprobe, 2.0 * ivf.nlist * U),
        ("ivf_probe", "ivf_probe", None, launches["ivf_probe"],
         lambda: ivf_probe_stream(probe, ivf._cell_rows, ivf._cells8, v, k),
         lambda: ivf_probe_stream_ref(probe, ivf._cell_rows, ivf._cells8, v, k),
         f32_tol(U, float((ivf._cell_rows[probe.long()].abs() @ v.abs()).max())),
         4.0 * n_valid * U + 4 * ivf.nprobe * (ivf._cells8.shape[1] + 1)
         + 4 * U + 8 * k, 2.0 * n_valid * U),
        ("mwem_step", "mwem_step", None, launches["mwem_step"],
         lambda: mwem_step(lw0, p, ps0, Q, sel, h, noise, rule="hardt",
                           eta=math.sqrt(math.log(U) / T)),
         lambda: mwem_step_ref(lw0, p, ps0, Q, sel, h, noise, rule="hardt",
                               eta=math.sqrt(math.log(U) / T)),
         None, 4.0 * 8 * U + 16, 12.0 * U),
        ("gather_score", "gather_score", None, launches["gather_score"],
         lambda: gather_score(Q, v, aug, active),
         lambda: gather_score_ref(Q, v, aug, active),
         f32_tol(U, vq), 4.0 * n_act * U + 4 * U + 13 * tail_cap,
         2.0 * n_act * U),
    ]
    # The wave's kernels at the IVF wave's shapes: its last probes, the
    # union of their cells, lane state from its release.
    Vb = hb_main - waves["ivf"].p_hat
    slots, member, _ = batch_probe_slots(ivf._cents, Vb, ivf.nprobe)
    cap8 = ivf._cells8.shape[1]
    rows_ok = (ivf._cells8[slots.long()] >= 0).sum(1).double()
    n_unique = int((member.sum(1) > 0).sum())
    rows_read = float((rows_ok * (member.sum(1) > 0)).sum())  # unique cells
    pairs = float((rows_ok * member.sum(1).double()).sum())   # (row, lane)
    log(json.dumps({"wave_probe_plan": {"slots": slots.numel(),
                                        "unique_cells": n_unique,
                                        "rows_read": rows_read,
                                        "row_lane_pairs": pairs}}))
    lw_b = torch.zeros(LANES, U, device=dev)
    p_b = torch.softmax(lw_b, 1)
    ps_b = waves["ivf"].p_hat.clone()
    sel_b = torch.as_tensor(waves["ivf"].selected[:, -1], device=dev)
    noise_b = torch.full((LANES,), 1e-3, device=dev)
    aug_b = torch.randint(0, 2 * m, (LANES, tail_cap), generator=rows_gen,
                          device=dev)
    active_b = torch.rand(LANES, tail_cap, generator=rows_gen, device=dev) < 0.25
    n_act_b = int(active_b.sum())
    eta = math.sqrt(math.log(U) / T)
    cases += [
        ("ivf_probe_batch", "ivf_probe_batch", None, launches["ivf_probe_batch"],
         lambda: ivf_probe_stream_batch(slots, member, ivf._cell_rows,
                                        ivf._cells8, Vb, k),
         lambda: ivf_probe_stream_batch_ref(slots, member, ivf._cell_rows,
                                            ivf._cells8, Vb, k),
         f32_tol(U, float(max((ivf._cell_rows[slots[:n_unique].long()].abs()
                               @ Vb[b].abs()).max() for b in range(LANES)))),
         4.0 * rows_read * U + 4 * LANES * U + 4 * n_unique * cap8
         + 4 * slots.numel() * (1 + LANES) + 8 * LANES * k + 4 * LANES,
         2.0 * pairs * U),
        ("mwem_step_batch", "mwem_step_batch", None, launches["mwem_step_batch"],
         lambda: mwem_step_batch(lw_b, p_b, ps_b, Q, sel_b, hb_main, noise_b,
                                 rule="hardt", eta=eta),
         lambda: mwem_step_batch_ref(lw_b, p_b, ps_b, Q, sel_b, hb_main,
                                     noise_b, rule="hardt", eta=eta),
         None, LANES * (4.0 * 8 * U + 12), LANES * 12.0 * U),
        ("gather_score_batch", "gather_score_batch", None,
         launches["gather_score_batch"],
         lambda: gather_score_batch(Q, Vb, aug_b, active_b),
         lambda: gather_score_batch_ref(Q, Vb, aug_b, active_b),
         f32_tol(U, float((Q.abs() @ Vb.abs().T).max())),
         4.0 * n_act_b * U + 4 * LANES * U + 13 * LANES * tail_cap,
         2.0 * n_act_b * U),
    ]
    rows_out = []
    for row, name, mode, n_launch, kern, plain, tol, nbytes, flops in cases:
        got, want = kern(), plain()
        torch.cuda.synchronize()
        if name == "mips_topk" or name == "ivf_probe":
            ok, err = same_topk(got[0], got[1], want[0], want[1], tol)
            if name == "ivf_probe":
                ok = ok and int(got[2]) == int(want[2])
        elif name == "ivf_probe_batch":
            ok, err = torch.equal(got[2], want[2]), 0.0
            for b in range(LANES):
                ok_b, err_b = same_topk(got[0][b], got[1][b], want[0][b],
                                        want[1][b], tol)
                ok, err = ok and ok_b, max(err, err_b)
        elif name.startswith("gather_score"):
            err = float((got - want).abs().max())
            ok = err <= tol
        else:
            err = max(float((a - b).abs().max()) for a, b in zip(got, want))
            ok = all(torch.allclose(a, b, rtol=1e-4, atol=1e-7)
                     for a, b in zip(got, want))
        expect(ok, f"{row} at main-path shapes: max err {err} (tol {tol})")
        ms, plain_ms = time_ms(kern), time_ms(plain)
        b_ms, b_by = bound_ms(nbytes, flops)
        out = {"name": row, "route": "cuda", "source": SOURCES[name],
               "replaces": REPLACES[name], "launches": n_launch,
               "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
        if mode:
            out["mode"] = mode
        rows_out.append(out)
        log(f"{row}: {ms:.4f} ms (plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms "
            f"by {b_by}), max err {err:.3g}, launches {n_launch}")

    if failures:
        log(f"chip_smoke: {len(failures)} check(s) failed")
        return 1
    print(card)
    print(json.dumps({"kernels": rows_out}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
