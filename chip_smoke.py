#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of Fast-MWEM on one NVIDIA card.

    python3 chip_smoke.py [--seed 0] [--T 500] [--m-log2 16] [--n-records 100000]
                          [--attrs 15] [--lp-T 200]

1. Builds the port's CUDA kernels from ``src/repro_torch/csrc`` (one nvcc
   per source, in parallel) into ``build/repro_torch/``.
2. Holds every kernel against its plain PyTorch version on the card, at
   ragged edge shapes (a row count that is no tile multiple, fewer valid
   IVF candidates than k, exact ties); K3 at every boundary of its routes
   (`score_plan`) ±1, on 1, 8 and 33 lanes, with no, the last or all slots
   active, bit for bit repeatable and lane by lane equal to single-lane
   calls.
3. Checks the whole release loop on a small input: the card's run and the
   CPU run of the plain versions, fed the same draws, must select the same
   queries and release the same histogram.
4. Runs the main path through `run_mwem` at the `fastmwem-synth` domain
   (U = 2**14) with m = 2**16 base queries, T = 500, (ε, δ) = (1, 1e-3),
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
7. Factored k-way marginal workloads: holds K6 (`marginal_gather_score`)
   to its plain version at edge shapes (cliques of 1 to 6 attributes with
   padded arities, heterogeneous cards, cliques listed in descending
   attribute order and over all attributes, a domain that is no multiple
   of the block, one candidate, no active slot, − signs, U = 2**15 with
   every slot of the main path's tail active, and U = 2**16) and K2 past
   U = 16384 (U = 16385 and 32768 on one cluster launch, 32769, 65536,
   100000, 131072 and 131073 on three launches; all three rules; one lane and an
   8-lane wave with shared and per-lane h; two launches must agree bit for
   bit, lane b must equal the single-lane launch on lane b); checks a small
   factored release, card against CPU on numpy draws, in exact, flat and
   marginal-IVF mode; then
   runs the factored main path — all 4-way marginals over ``--attrs`` = 15
   binary attributes (U = 2**15, m = 21840, no dense table:
   `benchmarks/bench_marginals.py:75-79`), n = 100000 records drawn as
   multinomial counts under ``softmax(2·N(0,1))`` logits, T = 500 — in
   exact, fast/flat and fast/marginal-IVF mode (each below the uniform
   baseline, each ledger equal to its preview, K6 and K2's cluster route
   launched in both fast modes, every K2 step on one cluster launch), the
   adaptive worst-marginal loop (T = 30) on the same workload, and profiles
   51 iterations of each factored mode as in step 5.
8. Holds every kernel against its plain version again at the shapes the
   main paths gave it — K1 in `aug` mode over Q (the flat probe) and in
   `plain` mode over the IVF centroids (the IVF probe's first step), K5,
   K2 and K3 at the wave's shapes, K6 and K2's cluster route at the
   factored path's, K2's three launches at U = 2**18 (`timing_only`) — and
   times each with CUDA events, one replay at a time and over 200
   back-to-back replays, each behind a sleep queued on the stream so the
   host's graph launch is not counted; K2's, K3's and K7's rows also check
   by profiler that one call launched just the kernels of its route. K3's
   dense rows have as many active slots, a prefix, as the flat run's (one
   lane) or the IVF wave's (8 lanes) mean tail.

9. The LM serving tier (`repro_torch.models.LM` under
   `repro_torch.serve.engine.ServeEngine`): holds K8 (flash attention) and
   K9 (the SSD scan) to their plain versions at edge shapes (four masks,
   GQA groups 1/3/8, head dims 12 to 128, ragged Sq and Skv, decode rows at
   a cache position with the kv range split, a softcap, rows that see no
   key, bf16 and f32; K8's bf16 tensor-core prefill route up to llama's
   heads at 2048 × 2048 and its decode route at Skv = 1 … 2112 with
   g·Sq = 1 … 16, each case logged with the route `plan()` chose; ragged SSD
   chunks, y and the final state); serves the
   two smoke configurations on the card and on the CPU with the same f32
   weights (logits, and tokens under the margin rule); then serves
   llama3.2-3b at its published widths and depth (28 layers, bf16, random
   weights from ``--seed``): 8 greedy requests with prompts of 256–2048
   tokens and 32 new tokens plus one short request that refills a freed
   slot, in waves of 4 — K8 launched 28 times a prefill and a decode step,
   finite logits, decode logits equal to the prefill of the extended prompt
   on two requests — and mamba2-130m (24 layers, prompts of 256–1024, K9
   launched 24 times a prefill); profiles one prefill and one decode window
   of each (the ``serve/engine/*`` ranges); and times K8 at the prefill and
   decode shapes and K9 at the prefill shape beside their plain versions
   and, for K8, `scaled_dot_product_attention` as the library yardstick
   (the decode row also by 200 back-to-back replays, `replayed_ms`).
   Before that, right after step 6's small waves, IVF waves of 17 and 24
   lanes (more than one K5 launch takes) must equal their lanes run one by
   one.
10. The private LP solvers (run before step 9's serving): holds K7
   (`mwu_update`, the fused multiplicative-weights update) to its plain
   version at U = 1 … 2**20 and every boundary of its routes (`plan`) ±1,
   one row and 8-row grids, three steps, dense and row-id forms, bit for
   bit repeatable, and K1 (``plain``), K3 and K4 at the LP widths 21 and
   300; solves small scalar and dual LPs and LP waves on the card and on
   the CPU with the same draws (equal selections), each card lane against
   the card's single solve; then the paper's sizes
   (`benchmarks/bench_lp.py`): the scalar solver at m = 2**18, d = 20,
   T = 200 in exact, fast/flat and fast/IVF mode, waves of 8 lanes
   (fast/flat; exact with one b a lane), and the constraint-private dual
   at (m, d) = (300, 1024), s = 12, in exact and fast/flat mode — each
   with K7 launched once an iteration, x̄ a distribution (the dual's in
   K_OPT), the ledger equal to its `lp_release_cost` preview; and times K7
   at the paths' shapes ((1, 20), (8, 20), (1, 300); (1, 2**20) as a
   `timing_only` line) beside `torch.softmax(torch.add(...))`, and K1,
   K3, K4 at the LP shapes.

It needs one CUDA device and exits non-zero, printing no result, without
one. The last lines are the card, the per-kernel JSON line and the result.
"""

from __future__ import annotations

import argparse
import itertools
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
BF16_FLOP_PER_S = 989e12    # H100 SXM bf16 tensor cores, dense
LLAMA, MAMBA = "llama3.2-3b", "mamba2-130m"
LM_BATCH, LM_NEW_TOKENS = 4, 32            # requests a wave, tokens each
LLAMA_PROMPTS, MAMBA_PROMPTS = (256, 2048), (256, 1024)  # prompt lengths
LANES = 8  # the serving tier's wave, src/repro/serve/release_service.py:218
KERNELS = ("mips_topk", "ivf_probe", "mwem_step", "gather_score",
           "ivf_probe_batch", "mwem_step_batch", "gather_score_batch",
           "marginal_gather_score", "mwem_step:cluster",
           "flash_attention", "flash_attention:decode", "ssd_scan",
           "mwu_update", "mwu_update:wave", "mwu_update:dual", "mips_topk:lp",
           "ivf_probe:lp", "gather_score_batch:lp", "mips_topk:dual",
           "gather_score:dual")
# Timed and checked like a kernel of the list, but no main path runs them
# (a factored wave is not ported; no path has U past K2's cluster reach, so
# none runs its three launches; no path updates a row of 2**20 weights with
# K7; no wave draws a quarter of its tail, which K3 reads past the 50 MB L2
# while the paths' tails stay in it): their lines are logged, not in the
# result.
TIMING_ONLY = ("mwem_step_batch:cluster", "mwem_step:multiblock",
               "mwu_update:2^20", "gather_score_batch:dense")
REPLACES = {
    "mips_topk": "src/repro/kernels/mips_topk/mips_topk.py:97",
    "ivf_probe": "src/repro/kernels/ivf_probe/ivf_probe.py:120",
    "mwem_step": "src/repro/kernels/mwem_step/mwem_step.py:103",
    "gather_score": "src/repro/kernels/mwem_step/mwem_step.py:139",
    "ivf_probe_batch": "src/repro/kernels/ivf_probe/ivf_probe.py:215",
    "mwem_step_batch": "src/repro/kernels/mwem_step/mwem_step.py:103",
    "gather_score_batch": "src/repro/kernels/mwem_step/mwem_step.py:139",
    "marginal_gather_score": "src/repro/kernels/mwem_step/mwem_step.py:189",
    "mwem_step:cluster": "src/repro/kernels/mwem_step/mwem_step.py:103",
    "mwem_step_batch:cluster": "src/repro/kernels/mwem_step/mwem_step.py:103",
    "mwem_step:multiblock": "src/repro/kernels/mwem_step/mwem_step.py:103",
    "flash_attention": "src/repro/kernels/flash_attention/flash_attention.py:112",
    "flash_attention:decode":
        "src/repro/kernels/flash_attention/flash_attention.py:112",
    "ssd_scan": "src/repro/kernels/ssd_scan/ssd_scan.py:65",
    "mwu_update": "src/repro/kernels/mwu_update/mwu_update.py:61",
}
SOURCES = {
    "mips_topk": "src/repro_torch/csrc/mips_topk.cu",
    "ivf_probe": "src/repro_torch/csrc/ivf_probe.cu",
    "mwem_step": "src/repro_torch/csrc/mwem_step.cu",
    "gather_score": "src/repro_torch/csrc/mwem_step.cu",
    "ivf_probe_batch": "src/repro_torch/csrc/ivf_probe.cu",
    "mwem_step_batch": "src/repro_torch/csrc/mwem_step.cu",
    "gather_score_batch": "src/repro_torch/csrc/mwem_step.cu",
    "marginal_gather_score": "src/repro_torch/csrc/mwem_step.cu",
    "mwem_step:cluster": "src/repro_torch/csrc/mwem_step.cu",
    "mwem_step_batch:cluster": "src/repro_torch/csrc/mwem_step.cu",
    "mwem_step:multiblock": "src/repro_torch/csrc/mwem_step.cu",
    "flash_attention": "src/repro_torch/csrc/flash_attention.cu",
    "flash_attention:decode": "src/repro_torch/csrc/flash_attention.cu",
    "ssd_scan": "src/repro_torch/csrc/ssd_scan.cu",
    "mwu_update": "src/repro_torch/csrc/mwu_update.cu",
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


SLEEP_CYCLES = 200_000  # ≈ 0.1 ms of the SM clock: longer than a graph launch


def _graph_of(fn):
    """A CUDA graph that captured one call of ``fn`` (run once first on a
    side stream, so lazy set-up such as a workspace's growth stays out of
    the capture), replayed once."""
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
    return graph


def time_ms(fn, reps: int = 20) -> float:
    """Median device time of one call of ``fn``, by CUDA events around
    replays of a CUDA graph that captured the call — so the host's Python
    overhead between launches is not counted. A `torch.cuda._sleep` queued
    before the start event keeps the card busy while the host records it
    and launches the graph, so the replay starts right after the event and
    the host's launch is not counted either."""
    import torch

    graph = _graph_of(fn)
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def replayed_ms(fn, n: int = 200) -> float:
    """Mean device time of one call of ``fn`` over ``n`` back-to-back
    replays of a CUDA graph between one pair of CUDA events: for a kernel
    of a few microseconds, `time_ms`'s one event pair a replay measures
    mostly the replay's own overhead. As in `time_ms`, a sleep queued first
    lets the host queue all ``n`` replays before the start event, so the
    card runs them back to back and the host's pace is not counted."""
    import torch

    graph = _graph_of(fn)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES * n // 5)
    a.record()
    for _ in range(n):
        graph.replay()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def stage_ms(fn, reps: int = 20) -> dict:
    """Mean device ms a call of ``fn`` spends in each kernel it launches,
    by kernel name, from one `torch.profiler` trace of ``reps`` calls: the
    stages (score, select, decode) of a multi-launch kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = e.name.removeprefix("void ").replace("(anonymous namespace)::", "")
            name = name.split("(")[0].split("<")[0].rsplit("::", 1)[-1]
            out[name] = out.get(name, 0.0) + e.time_range.elapsed_us() / 1e3 / reps
    return out


def bound_ms(nbytes: float, flops: float,
             flop_per_s: float = F32_FLOP_PER_S) -> tuple[float, str]:
    t_mem, t_ops = nbytes / HBM_BYTES_PER_S, flops / flop_per_s
    return 1e3 * max(t_mem, t_ops), "bytes" if t_mem >= t_ops else "operations"


# The kernels one call launches, by route: K7's (`kernels/mwu_update/ops.py::
# plan`) and K3's (`kernels/mwem_step/ops.py::score_plan`).
K7_KERNELS = {"warp": {"mwu_warp_kernel"}, "block": {"mwu_block_kernel"},
              "grid": {"mwu_grid_partial_kernel", "mwu_grid_norm_kernel"}}
K3_KERNELS = {"narrow": {"gather_score_narrow_kernel"},
              "split": {"gather_score_split_kernel"}}


def score_route(route_nseg: tuple) -> str:
    """K3's `score_plan` as a row's mode: ``narrow`` or ``split:<segments>``."""
    route, nseg = route_nseg
    return route if route == "narrow" else f"{route}:{nseg}"


def check_score_stages(row: str, kern, mode: str, expect) -> None:
    """Log a K3 row's profiler stages and check that one call launched just
    the kernel of its route."""
    stages = stage_ms(kern)
    log(json.dumps({"stages_ms": row, **stages}))
    want_k = K3_KERNELS[mode.split(":")[0]]
    expect(set(stages) == want_k,
           f"{row}: one call launched {sorted(stages)}, not {sorted(want_k)}")


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
        for attr in [a for a in vars(fn) if a.startswith("launches")]:
            setattr(fn, attr, 0)


def read_counts(ops) -> dict:
    """Each kernel's launches since `reset_counts`; a route a wrapper
    counts apart (``launches_<route>``: K2's calls past U = 16384 and those
    of them on one cluster launch, K8's decode route) under its own row
    name ``<kernel>:<route>``."""
    counts = {}
    for name, fn in ops.items():
        counts[name] = fn.launches
        for attr, value in vars(fn).items():
            if attr.startswith("launches_"):
                counts[f"{name}:{attr[len('launches_'):]}"] = value
    return counts


def profile_window(run, step_kernel: str = "mwem_step_cluster_kernel") -> tuple:
    """``run()``'s result and the device busy share of its iterations
    after the first (T of them, 51 here, give a window of 50), from one
    `torch.profiler` trace: the window runs from the end of iteration 0's
    last K2 kernel (``step_kernel``: K2's one cluster launch, or K7 for
    the LP) to the end of the last one, so set-up and the final error
    evaluation lie outside it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        res = run()
        torch.cuda.synchronize()
    gpu = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    step_ends = sorted(e.time_range.end for e in gpu
                       if step_kernel in e.name)
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


# ------------------------------------------- K1 and K5: their select's edges

def k1_edge_cases(dev, g, expect) -> None:
    """K1 against its plain version on each of its routes (`ops.plan`:
    ``split`` up to 4096 candidates, ``narrow`` at d ≤ 32, ``rows``) in all
    three modes: the three main-path shapes at reduced n (d = 21 with
    k = 512, d = 2**14 with k = 10, d = 300 with k = 32), k = 1, k = the
    candidate count (or MAX_K), k = MAX_K, and bit for bit (ids and scores
    equal): integer-valued rows, all-equal rows (the tie rank decides every
    place), ±0.0 scores and ±inf scores, each cut through its ties."""
    import torch
    from repro_torch.kernels.mips_topk import MODES, mips_topk, mips_topk_ref
    from repro_torch.kernels.mips_topk.ops import MAX_K, plan

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    def randint(*shape, lo=-3, hi=4):
        return torch.randint(lo, hi, shape, generator=g, device=dev).float()

    def check(V, q, k, mode, what, exact=False):
        n, d = V.shape
        got, want = mips_topk(V, q, k, mode), mips_topk_ref(V, q, k, mode)
        if exact:
            ok = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
            err = 0.0 if ok else math.inf
        else:
            ok, err = same_topk(*got, *want,
                                f32_tol(d, float((V.abs() @ q.abs()).max())))
        expect(ok, f"mips_topk {mode} {what} n={n} d={d} k={k} "
               f"({plan(n, d, k, mode)['route']}): max err {err}")

    for n, d, k in ((20000, 21, 512), (300, 2 ** 14, 10), (700, 300, 32)):
        V, q = randn(n, d), randn(d)
        for mode in MODES:
            check(V, q, k, mode, "main-path shape")
    for n, d in ((700, 300), (4500, 21), (5000, 64), (20, 5)):
        for mode in MODES:
            n_cand = 2 * n if mode == "aug" else n
            V, q = randn(n, d), randn(d)
            for k in sorted({1, min(n_cand, MAX_K)}):
                check(V, q, k, mode, "random")
            kk = min(n_cand // 2 + 3, MAX_K)
            check(randint(n, d), randint(d), kk, mode, "integer", exact=True)
            check(torch.ones(n, d, device=dev), randint(d, lo=1), kk, mode,
                  "all-equal rows", exact=True)
            Vz = torch.zeros(n, d, device=dev)
            Vz[1::3] = -0.0
            Vz[2::3] = randint(len(range(2, n, 3)), d, lo=1)
            q = randint(d, lo=1)
            n_pos = len(range(2, n, 3))  # rows > 0; aug adds their −s below ±0
            check(Vz, q, min(n_pos + (n - n_pos) // 2 + 1, n_cand), mode,
                  "±0.0", exact=True)
            Vi = randint(n, d)
            Vi[::4, 0], Vi[2::4, 0] = math.inf, -math.inf
            q = randint(d, lo=1)
            for k in sorted({min(len(range(0, n, 4)) + 1, n_cand),
                             min(n_cand, MAX_K)}):
                check(Vi, q, k, mode, "±inf", exact=True)
    for n, d, mode in ((9000, 21, "plain"), (5000, 64, "aug"), (8192, 300, "abs")):
        check(randn(n, d), randn(d), MAX_K, mode, "k = MAX_K")
    torch.cuda.synchronize()


def k5_edge_cases(dev, g, expect) -> None:
    """K5 against its plain version: d that is no multiple of the d-split
    (the last split short; d % 4 ≠ 0 takes 4-byte copies), lanes 1, 3, 8
    and 16, a probed cell of pad rows only, k above a lane's valid rows
    (ids −1, scores −inf past them), cap no multiple of an item's rows.
    n_valid exactly; ids and scores bit for bit on integer-valued rows,
    else within `f32_tol`. Each case logs the plan's splits."""
    import torch
    from repro_torch.kernels.ivf_probe import (batch_probe_slots,
                                               ivf_probe_stream_batch,
                                               ivf_probe_stream_batch_ref)
    from repro_torch.kernels.ivf_probe.ops import wave_plan

    def case(lanes, d, k, integer, what, nlist=40, cap=150, n_ok=120,
             nprobe=4, empty=False):
        if integer:
            rows = torch.randint(-3, 4, (nlist, cap, d), generator=g,
                                 device=dev).float()
            qb = torch.randint(-3, 4, (lanes, d), generator=g, device=dev).float()
        else:
            rows = torch.randn(nlist, cap, d, generator=g, device=dev)
            qb = torch.randn(lanes, d, generator=g, device=dev)
        ids = torch.arange(nlist * cap, device=dev,
                           dtype=torch.int32).reshape(nlist, cap)
        ids[:, n_ok:] = -1
        rows[:, n_ok:] = 0
        cents = torch.randn(nlist, d, generator=g, device=dev)
        slots, member, _ = batch_probe_slots(cents, qb, nprobe)
        if empty:  # the first probed cell holds pad rows only
            ids[int(slots[0])] = -1
            rows[int(slots[0])] = 0
        got = ivf_probe_stream_batch(slots, member, rows, ids, qb, k)
        want = ivf_probe_stream_batch_ref(slots, member, rows, ids, qb, k)
        ok, err = torch.equal(got[2], want[2]), 0.0
        if integer:
            ok = ok and torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        else:
            tol = f32_tol(d, float((rows.abs().reshape(-1, d) @ qb.abs().T).max()))
            for b in range(lanes):
                ok_b, err_b = same_topk(got[0][b], got[1][b], want[0][b],
                                        want[1][b], tol)
                ok, err = ok and ok_b, max(err, err_b)
        p = wave_plan(slots.numel(), cap, d, lanes)
        expect(ok, f"ivf_probe_batch {what} B={lanes} d={d} k={k} "
               f"(splits {p['splits']} of {p['dsplit']}): max err {err}, "
               f"n_valid {got[2].tolist()} / {want[2].tolist()}")

    for d in (2000, 1500, 2001):  # two splits of 1024 at 8 lanes, the last short
        case(8, d, 64, False, "ragged split")
        case(8, d, 64, True, "ragged split, integer")
    for lanes in (1, 3, 8, 16):
        case(lanes, 1500, 50, False, "lanes")
        case(lanes, 1500, 50, True, "lanes, integer")
        case(lanes, 520, 40, True, "pad-only cell", empty=True)
        case(lanes, 300, 500, False, "k above the valid rows", nprobe=2)
    torch.cuda.synchronize()


# ------------------------------------------------------ the LM serving tier

class Metered:
    """A model proxy for `ServeEngine` that counts its prefill and decode
    calls, times each by CUDA events on the card, tracks whether every
    logits row was finite and, when asked, keeps each call's logits on the
    host."""

    def __init__(self, model, keep_logits: bool = False):
        import torch

        self.model = model
        self.device = model.device
        self.keep_logits = keep_logits
        self.calls = {"prefill": [], "decode": []}   # (start, end, tokens)
        self.logits = []
        self.finite = torch.ones((), dtype=torch.bool, device=model.device)

    def _timed(self, kind, n_tokens, fn, *args, **kw):
        import torch

        on_card = self.device.type == "cuda"
        if on_card:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        logits, cache = fn(*args, **kw)
        if on_card:
            end.record()
            self.calls[kind].append((start, end, n_tokens))
        self.finite &= torch.isfinite(logits).all()
        if self.keep_logits:
            self.logits.append(logits.float().cpu().numpy())
        return logits, cache

    def prefill(self, batch, max_len=None):
        return self._timed("prefill", batch["tokens"].numel(),
                           self.model.prefill, batch, max_len=max_len)

    def decode_step(self, cache, tokens, pos):
        return self._timed("decode", tokens.shape[0], self.model.decode_step,
                           cache, tokens, pos)

    def summary(self) -> dict:
        import torch

        torch.cuda.synchronize()
        out = {}
        for kind, calls in self.calls.items():
            ms = sum(a.elapsed_time(b) for a, b, _ in calls)
            toks = sum(n for _, _, n in calls)
            out[kind] = {"calls": len(calls), "device_ms": ms, "tokens": toks,
                         "tokens_per_s": 1e3 * toks / ms if ms else None,
                         "ms_per_call": ms / len(calls) if calls else None}
        return out


def same_greedy_serving(ref_logits, logits, margin: float,
                        tol: float) -> tuple[bool, int, float]:
    """The margin rule over two engines' logits, call by call: while every
    row's reference top-1 beats its runner-up by more than ``margin``, the
    argmax must agree and the logits lie within ``tol``; a row under the
    margin ends the comparison (the runs may part there). Returns (ok,
    calls compared, max |Δlogit|)."""
    err, n = 0.0, 0
    for a, b in zip(ref_logits, logits):
        top2 = np.sort(a, axis=-1)[:, -2:]
        if ((top2[:, 1] - top2[:, 0]) <= margin).any():
            break
        if a.shape != b.shape or not (a.argmax(-1) == b.argmax(-1)).all():
            return False, n, math.inf
        err = max(err, float(np.abs(a - b).max()))
        n += 1
    scale = max(1.0, max(float(np.abs(a).max()) for a in ref_logits))
    return n > 0 and err <= tol * scale, n, err


def lm_edge_shapes(dev, g, expect) -> None:
    """K8 and K9 against their plain versions on the card at edge shapes.
    Tolerances: f32 rtol/atol 2e-4 (the reference's kernel tests: an online
    softmax or a chunked scan against one pass, sums in another order; the
    scan's atol scaled by the output's magnitude); bf16 2e-2 (outputs
    rounded to 8 mantissa bits; the `mma` route also rounds P to bf16
    before P·V, ≈ 2**-9 relative a weight). Each K8 case logs the route
    `plan()` chose for it."""
    import torch
    from repro_torch.kernels.flash_attention import attention_ref, flash_attention
    from repro_torch.kernels.flash_attention.ops import plan
    from repro_torch.kernels.ssd_scan import ssd_chunked, ssd_scan

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    f32, bf = torch.float32, torch.bfloat16
    # (B, Hq, Hkv, Sq, Skv, D, mode, window, q_offset, softcap, dtypes)
    both = (f32, bf)
    cases = [
        (2, 4, 4, 100, 100, 64, "full", 0, 0, 0.0, both),         # GQA 1
        (1, 24, 8, 257, 257, 128, "causal", 0, 0, 0.0, both),     # GQA 3, llama heads
        (2, 16, 2, 70, 130, 64, "causal", 0, 60, 0.0, both),      # GQA 8, continuation
        (1, 8, 1, 129, 129, 128, "window", 33, 0, 0.0, both),
        (1, 6, 2, 150, 150, 64, "chunk", 40, 0, 0.0, both),
        (3, 24, 8, 1, 2112, 128, "causal", 0, 1500, 0.0, both),   # decode, kv split
        (2, 8, 1, 1, 700, 128, "window", 100, 650, 0.0, both),    # decode, GQA 8
        (2, 12, 3, 4, 300, 64, "causal", 0, 296, 0.0, both),      # 16 rows of Sq 4
        (1, 4, 2, 45, 77, 12, "causal", 0, 0, 0.0, both),         # smoke head dim
        (1, 4, 1, 50, 50, 100, "causal", 0, 0, 30.0, both),       # ragged D, softcap
        (1, 2, 1, 4, 30, 64, "chunk", 16, 40, 0.0, both),         # rows see no key
        # the bf16 tensor-core prefill route
        (1, 24, 8, 2048, 2048, 128, "causal", 0, 0, 0.0, (bf,)),  # llama heads at full length
        (1, 24, 8, 333, 333, 128, "causal", 0, 0, 0.0, (bf,)),    # 999 rows: no 16 or BQ multiple
        (2, 6, 2, 40, 40, 64, "causal", 0, 0, 0.0, (bf,)),        # Skv < 64
        (1, 8, 8, 20, 50, 128, "full", 0, 0, 0.0, (bf,)),         # GQA 1, Skv < 64
        (1, 16, 2, 200, 456, 128, "causal", 0, 256, 0.0, (bf,)),  # GQA 8, continuation
        (1, 24, 8, 700, 700, 128, "window", 150, 0, 0.0, (bf,)),  # window over tiles
        (1, 24, 8, 700, 700, 128, "chunk", 192, 0, 0.0, (bf,)),   # chunk over tiles
        (2, 8, 1, 500, 500, 64, "chunk", 100, 0, 0.0, (bf,)),     # GQA 8 chunk
        (2, 6, 2, 300, 300, 12, "causal", 0, 0, 0.0, (bf,)),      # D 12
        (1, 6, 3, 260, 260, 100, "window", 70, 0, 0.0, (bf,)),    # D 100, scalar loads
        (2, 8, 1, 3, 500, 64, "causal", 0, 497, 0.0, (bf,)),      # 24 rows
        (1, 8, 1, 4, 30, 64, "chunk", 16, 40, 0.0, both),         # 32 rows see no key
        # the decode route: Skv 1, 63, 64, 65, 2112; g·Sq 1, 2, 3, 8, 16
        (2, 8, 8, 1, 1, 128, "causal", 0, 0, 0.0, both),
        (1, 24, 8, 1, 63, 128, "causal", 0, 62, 0.0, both),
        (2, 8, 1, 1, 64, 64, "causal", 0, 63, 0.0, both),
        (1, 16, 1, 1, 65, 128, "full", 0, 64, 0.0, both),
        (4, 24, 8, 1, 2112, 128, "causal", 0, 1901, 0.0, both),  # llama's decode
        (2, 4, 4, 1, 2112, 64, "window", 300, 2000, 0.0, both),
        (1, 8, 1, 1, 2112, 128, "chunk", 512, 2111, 0.0, both),
        (1, 8, 2, 4, 2112, 128, "causal", 0, 2108, 0.0, both),
        (2, 4, 2, 1, 700, 64, "causal", 0, 699, 0.0, both),
        (1, 8, 8, 1, 65, 12, "causal", 0, 64, 0.0, both),
        (2, 3, 1, 1, 63, 100, "causal", 0, 62, 20.0, both),
    ]
    routes = {}
    for B, Hq, Hkv, Sq, Skv, D, mode, window, off, cap, dtypes in cases:
        for dtype in dtypes:
            tol = 2e-4 if dtype == f32 else 2e-2
            q = (randn(B, Hq, Sq, D) * (4.0 if cap else 1.0)).to(dtype)
            k, v = randn(B, Hkv, Skv, D).to(dtype), randn(B, Hkv, Skv, D).to(dtype)
            kw = dict(mode=mode, window=window, q_offset=off, logit_softcap=cap)
            got, want = flash_attention(q, k, v, **kw), attention_ref(q, k, v, **kw)
            err = float((got.float() - want.float()).abs().max())
            ok = got.dtype == dtype and torch.allclose(
                got.float(), want.float(), rtol=tol, atol=tol)
            if mode == "chunk" and off == 40:  # no key visible: exact zeros
                ok = ok and not bool(got.any())
            p = plan(B, Hq, Hkv, Sq, Skv, D, dtype)
            key = f"{p.route} {str(dtype)[6:]}"
            routes[key] = routes.get(key, 0) + 1
            shape = (f"B={B} Hq={Hq} Hkv={Hkv} Sq={Sq} Skv={Skv} D={D} {mode} "
                     f"w={window} off={off} cap={cap}")
            log(f"flash_attention {str(dtype)[6:]} {shape}: route {p.route} "
                f"bq={p.bq} nsplit={p.nsplit}, max err {err:.3g}")
            expect(ok, f"flash_attention {dtype} {shape} ({p.route}): "
                   f"max err {err}")
    log(json.dumps({"flash_attention_edge_routes": routes}))
    # (B, S, H, P, N, chunk)
    for B, S, H, P, N, chunk in ((2, 37, 3, 8, 12, 8), (1, 100, 2, 64, 128, 64),
                                 (2, 130, 4, 16, 16, 16), (1, 64, 1, 128, 128, 64),
                                 (3, 5, 2, 4, 4, 64), (4, 1000, 24, 64, 128, 64)):
        x, Bm, Cm = randn(B, S, H, P), randn(B, S, N), randn(B, S, N)
        dt = 0.01 + 0.49 * torch.rand(B, S, H, generator=g, device=dev)
        A = -(0.1 + 1.9 * torch.rand(H, generator=g, device=dev))
        got = ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)
        want = ssd_chunked(x, dt, A, Bm, Cm, chunk=min(chunk, max(8, S)))
        ok, err = True, 0.0
        for a, b in zip(got, want):
            scale = max(1.0, float(b.abs().max()))
            err = max(err, float((a - b).abs().max()) / scale)
            ok = ok and torch.allclose(a, b, rtol=2e-4, atol=2e-4 * scale)
        expect(ok, f"ssd_scan B={B} S={S} H={H} P={P} N={N} chunk={chunk}: "
               f"max err / scale {err}")
    torch.cuda.synchronize()


def small_lm_card_vs_cpu(dev, seed, expect) -> None:
    """Both smoke configurations in f32 with the same weights on the card
    and on the CPU: prefill and decode logits within rtol/atol 1e-4 (f32
    sums in another order through two layers), and a greedy serving run
    with a refill under the margin rule (1e-3)."""
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model
    from repro_torch.serve.engine import Request, ServeEngine

    cpu = torch.device("cpu")
    for arch in (LLAMA, MAMBA):
        cfg = get_smoke_config(arch).with_(dtype="float32")
        on_cpu = build_model(cfg).init(seed, device=cpu)
        on_card = build_model(cfg).load(on_cpu.state_dict(), device=dev)
        toks = np.random.default_rng([seed, 17]).integers(0, cfg.vocab_size,
                                                          (3, 21))
        err = 0.0
        lc, cc = on_cpu.prefill({"tokens": torch.as_tensor(toks[:, :17])},
                                max_len=24)
        lg, cg = on_card.prefill({"tokens": torch.as_tensor(toks[:, :17]).to(dev)},
                                 max_len=24)
        pairs = [(lc, lg)]
        for t in range(17, 21):
            col = torch.as_tensor(toks[:, t:t + 1])
            lc, cc = on_cpu.decode_step(cc, col, t)
            lg, cg = on_card.decode_step(cg, col.to(dev), t)
            pairs.append((lc, lg))
        ok = True
        for a, b in pairs:
            err = max(err, float((a - b.cpu()).abs().max()))
            ok = ok and torch.allclose(a, b.cpu(), rtol=1e-4, atol=1e-4)
        runs = []
        for model in (on_cpu, on_card):
            proxy = Metered(model, keep_logits=True)
            reqs = [Request(prompt=list(p), max_new_tokens=n) for p, n in
                    (([1, 2, 3], 2), ([4, 5, 6, 7, 8], 9), ([7, 8], 4),
                     ([9] * 11, 5))]
            engine = ServeEngine(proxy, batch_size=2, max_len=32, seed=seed,
                                 device=model.device)
            engine.run(reqs)
            runs.append((reqs, engine, proxy.logits))
        (r_cpu, e_cpu, l_cpu), (r_card, e_card, l_card) = runs
        same, n, serr = same_greedy_serving(l_cpu, l_card, 1e-3, 1e-4)
        if n == len(l_cpu):
            same = same and [r.out_tokens for r in r_cpu] == [
                r.out_tokens for r in r_card] and e_cpu.refill_count == \
                e_card.refill_count >= 1
        log(json.dumps({"small_lm": arch, "logit_max_err": err,
                        "serve_calls_compared": n, "serve_calls": len(l_cpu),
                        "serve_max_err": serr, "refills": e_card.refill_count}))
        expect(ok, f"small {arch}: card and CPU logits differ by {err}")
        expect(same, f"small {arch}: card and CPU serving differ "
               f"({n} of {len(l_cpu)} calls compared, max err {serr})")


def serve_full(arch, dev, seed, lens, new_tokens, max_len, expect, ops,
               short=None) -> dict:
    """Serve requests with prompts of ``lens`` tokens (and the ``short``
    (prompt length, new tokens) request fifth in the queue, the head of the
    queue once the first wave is formed) on ``arch`` at its published
    widths, in waves of 4. Returns the run's record."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = get_config(arch)
    t0 = time.perf_counter()
    model = build_model(cfg).init(seed, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng([seed, 16, len(lens)])
    reqs = [Request(prompt=rng.integers(0, cfg.vocab_size, int(n)).tolist(),
                    max_new_tokens=new_tokens) for n in lens]
    if short is not None:
        reqs.insert(4, Request(prompt=rng.integers(0, cfg.vocab_size,
                                                   short[0]).tolist(),
                               max_new_tokens=short[1]))
    meter = Metered(model)
    engine = ServeEngine(meter, batch_size=4, max_len=max_len, seed=seed,
                         device=dev)
    torch.cuda.synchronize()
    reset_counts(ops)
    t0 = time.perf_counter()
    engine.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts(ops)
    summ = meter.summary()
    n_pre, n_dec = summ["prefill"]["calls"], summ["decode"]["calls"]
    rec = {"serve": arch, "layers": cfg.n_layers, "d_model": cfg.d_model,
           "params": sum(p.numel() for p in model.parameters()),
           "init_s": init_s, "requests": len(reqs),
           "prompt_lens": [len(r.prompt) for r in reqs],
           "new_tokens": [len(r.out_tokens) for r in reqs],
           "refills": engine.refill_count, "wall_s": wall,
           "prefill": summ["prefill"], "decode": summ["decode"],
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches": {k: counts[k] for k in
                        ("flash_attention", "flash_attention:decode", "ssd_scan")}}
    log(json.dumps(rec))
    expect(bool(meter.finite), f"{arch}: non-finite logits")
    expect(all(r.done and len(r.out_tokens) == r.max_new_tokens for r in reqs),
           f"{arch}: a request was not served in full")
    expect(all(0 <= t < cfg.vocab_size for r in reqs for t in r.out_tokens),
           f"{arch}: a token outside the vocabulary")
    if arch == LLAMA:
        expect(counts["flash_attention"] == cfg.n_layers * (n_pre + n_dec)
               and counts["ssd_scan"] == 0,
               f"{arch}: K8 launched {counts['flash_attention']} times, "
               f"not {cfg.n_layers} x ({n_pre} + {n_dec})")
        expect(counts["flash_attention:decode"] == cfg.n_layers * n_dec,
               f"{arch}: K8's decode route launched "
               f"{counts['flash_attention:decode']} times")
    else:
        expect(counts["ssd_scan"] == cfg.n_layers * n_pre
               and counts["flash_attention"] == 0,
               f"{arch}: K9 launched {counts['ssd_scan']} times, not "
               f"{cfg.n_layers} x {n_pre}")
    if short is not None:
        expect(engine.refill_count >= 1, f"{arch}: no slot was refilled")
    # decode at position S against the prefill of the prompt extended by
    # the decoded token, on two requests. bf16 tolerance: relative L2 error
    # of the logits ≤ 2**-4 (one bf16 rounding is 2**-9; the two routes
    # round in other places through every layer).
    rel = []
    for r in reqs[:2]:
        p, tok = r.prompt, r.out_tokens[0]
        _, cache = model.prefill({"tokens": torch.tensor([p], device=dev)},
                                 max_len=len(p) + 1)
        ld, _ = model.decode_step(cache, torch.tensor([[tok]], device=dev), len(p))
        lp, _ = model.prefill({"tokens": torch.tensor([p + [tok]], device=dev)})
        rel.append(float((ld - lp).norm() / lp.norm()))
    log(json.dumps({"decode_vs_prefill": arch, "relative_l2": rel}))
    expect(all(e <= 2 ** -4 for e in rel),
           f"{arch}: decode and prefill logits differ (relative L2 {rel})")
    rec["model"], rec["reqs"] = model, reqs
    return rec


def profile_lm(model, dev, prompts, max_len, steps: int = 8) -> None:
    """One profiled prefill of a wave of ``prompts`` and ``steps`` profiled
    decode steps, each under its ``serve/engine/*`` range. For each: host
    time in the range, the device's busy time (kernels, copies and fills)
    over the window from the first device operation's start to the last
    one's end, and the top device operations."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    width = max(len(p) for p in prompts)
    tokens = torch.zeros((len(prompts), width), dtype=torch.int64)
    for i, p in enumerate(prompts):
        tokens[i, width - len(p):] = torch.tensor(p)
    tokens = tokens.to(dev)

    def summarise(prof, name, n):
        evs = prof.events()
        gpu = [e for e in evs if e.device_type == DeviceType.CUDA
               and not e.name.startswith("serve/")]  # not the ranges' spans
        host = [e for e in evs if e.name == name and e.device_type == DeviceType.CPU]
        w0 = min(e.time_range.start for e in gpu)
        w1 = max(e.time_range.end for e in gpu)
        busy = {}
        for e in gpu:
            busy[e.name] = busy.get(e.name, 0.0) + e.time_range.elapsed_us()
        top = sorted(busy.items(), key=lambda kv: -kv[1])[:6]
        busy_ms = sum(busy.values()) / 1e3
        log(json.dumps({"profile": f"{model.cfg.name} {name}", "calls": n,
                        "host_ms_per_call": sum(e.time_range.elapsed_us()
                                                for e in host) / 1e3 / n,
                        "device_busy_ms_per_call": busy_ms / n,
                        "window_ms_per_call": (w1 - w0) / 1e3 / n,
                        "busy_share": busy_ms / ((w1 - w0) / 1e3),
                        "device_ops_per_call": len(gpu) / n,
                        "top": [[k[:70], us / 1e3 / n] for k, us in top]}))

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        with record_function("serve/engine/prefill"):
            logits, cache = model.prefill({"tokens": tokens}, max_len=max_len)
        torch.cuda.synchronize()
    summarise(prof, "serve/engine/prefill", 1)
    tok = logits.argmax(-1)[:, None]
    with profile(activities=acts) as prof:
        for i in range(steps):
            with record_function("serve/engine/decode"):
                logits, cache = model.decode_step(cache, tok, width + i)
            tok = logits.argmax(-1)[:, None]
        torch.cuda.synchronize()
    summarise(prof, "serve/engine/decode", steps)


def lm_phases(args, dev, expect, ops) -> list:
    """Step 9's serving phases after the edge shapes; returns the kernel
    rows of K8 (prefill and decode shapes) and K9."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import attention_ref, flash_attention
    from repro_torch.kernels.ssd_scan import ssd_chunked, ssd_scan

    small_lm_card_vs_cpu(dev, args.seed, expect)
    log(f"small LM, card vs CPU: {'ok' if not expect.failures else 'FAILED'}")
    rng = np.random.default_rng([args.seed, 18])
    runs = {}
    for arch, (lo, hi), short in ((LLAMA, LLAMA_PROMPTS, (64, 4)),
                                  (MAMBA, MAMBA_PROMPTS, None)):
        run = serve_full(arch, dev, args.seed, rng.integers(lo, hi + 1, 8),
                         LM_NEW_TOKENS, hi + 64, expect, ops, short=short)
        profile_lm(run.pop("model"), dev, [r.prompt for r in run["reqs"][:4]],
                   hi + 64)
        torch.cuda.empty_cache()
        runs[arch] = run
    log(f"LM serving: {'ok' if not expect.failures else 'FAILED'}")

    # ------------------------- K8 and K9 at the main path's shapes, timed:
    # llama's first wave (its padded prompt, its last decode position) and
    # mamba's first wave, on random inputs of those shapes
    lcounts, mcounts = runs[LLAMA]["launches"], runs[MAMBA]["launches"]
    cfg_l, cfg_m = get_config(LLAMA), get_config(MAMBA)
    S_pre = max(runs[LLAMA]["prompt_lens"][:LM_BATCH])
    pos_dec = S_pre + LM_NEW_TOKENS - 1
    S_m = max(runs[MAMBA]["prompt_lens"][:LM_BATCH])
    g = torch.Generator(device=dev).manual_seed(args.seed + 19)
    bf = torch.bfloat16
    B, L = LM_BATCH, LLAMA_PROMPTS[1] + 64
    Hq, Hkv, D = cfg_l.n_heads, cfg_l.n_kv_heads, cfg_l.resolved_head_dim

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=g, device=dev).to(dtype)

    q, k, v = (randn(B, h, S_pre, D, dtype=bf) for h in (Hq, Hkv, Hkv))
    qd = randn(B, Hq, 1, D, dtype=bf)
    kc, vc = randn(B, Hkv, L, D, dtype=bf), randn(B, Hkv, L, D, dtype=bf)
    kp, vp = kc[:, :, :pos_dec + 1].contiguous(), vc[:, :, :pos_dec + 1].contiguous()
    H = cfg_m.ssm_expand * cfg_m.d_model // cfg_m.ssm_headdim
    P, N, Q = cfg_m.ssm_headdim, cfg_m.ssm_state, cfg_m.ssm_chunk
    xs, Bs, Cs = randn(B, S_m, H, P), randn(B, S_m, N), randn(B, S_m, N)
    dts = 0.01 + 0.49 * torch.rand(B, S_m, H, generator=g, device=dev)
    As = -(0.1 + 1.9 * torch.rand(H, generator=g, device=dev))
    pairs_pre = B * Hq * S_pre * (S_pre + 1) / 2   # causal (query, key) pairs
    pairs_dec = B * Hq * (pos_dec + 1)
    chunks = -(-S_m // Q)

    def sdpa(qq, kk, vv, causal):
        return F.scaled_dot_product_attention(qq, kk, vv, is_causal=causal,
                                              enable_gqa=True)

    cases = [  # (row, launches, kernel, plain, library, tol, bytes, flops, peak)
        ("flash_attention",
         lcounts["flash_attention"] - lcounts["flash_attention:decode"],
         lambda: flash_attention(q, k, v, mode="causal"),
         lambda: attention_ref(q, k, v, mode="causal"),
         lambda: sdpa(q, k, v, True), 2e-2,
         2.0 * (2 * B * Hq * S_pre * D + 2 * B * Hkv * S_pre * D),
         4.0 * D * pairs_pre, BF16_FLOP_PER_S),
        ("flash_attention:decode", lcounts["flash_attention:decode"],
         lambda: flash_attention(qd, kc, vc, mode="causal", q_offset=pos_dec),
         lambda: attention_ref(qd, kc, vc, mode="causal", q_offset=pos_dec),
         lambda: sdpa(qd, kp, vp, False), 2e-2,
         2.0 * (2 * B * Hq * D + 2 * B * Hkv * (pos_dec + 1) * D),
         4.0 * D * pairs_dec, BF16_FLOP_PER_S),
        ("ssd_scan", mcounts["ssd_scan"],
         lambda: ssd_scan(xs, dts, As, Bs, Cs, chunk=Q),
         lambda: ssd_chunked(xs, dts, As, Bs, Cs, chunk=Q), None, 2e-4,
         4.0 * (2 * B * S_m * H * P + B * S_m * H + H + 2 * B * S_m * N
                + B * H * P * N),
         B * H * chunks * (2.0 * Q * Q * N + 2.0 * Q * Q * P + 4.0 * Q * P * N),
         F32_FLOP_PER_S),
    ]
    rows = []
    for row, n_launch, kern, plain, lib, tol, nbytes, flops, peak in cases:
        got, want = kern(), plain()
        if row == "ssd_scan":
            scale = max(1.0, float(want[0].abs().max()), float(want[1].abs().max()))
            err = max(float((a - b).abs().max()) for a, b in zip(got, want))
            ok = all(torch.allclose(a, b, rtol=tol, atol=tol * scale)
                     for a, b in zip(got, want))
        else:
            err = float((got.float() - want.float()).abs().max())
            ok = torch.allclose(got.float(), want.float(), rtol=tol, atol=tol)
        expect(ok, f"{row} at main-path shapes: max err {err} (tol {tol})")
        ms, plain_ms = time_ms(kern), time_ms(plain)
        lib_ms = time_ms(lib) if lib is not None else None
        b_ms, b_by = bound_ms(nbytes, flops, peak)
        out = {"name": row, "route": "cuda", "source": SOURCES[row],
               "replaces": REPLACES[row], "launches": n_launch,
               "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}
        out["replayed_ms"] = {"kernel": replayed_ms(kern), "plain": replayed_ms(plain),
                              "library": None if lib is None else replayed_ms(lib)}
        rows.append(out)
        log(f"{row}: {ms:.4f} ms (plain {plain_ms:.4f} ms, library "
            f"{'none' if lib_ms is None else f'{lib_ms:.4f} ms'}, bound "
            f"{b_ms:.4f} ms by {b_by}), max err {err:.3g}, launches {n_launch}"
            + f", back-to-back {out['replayed_ms']}")
    log(json.dumps({"lm_timing_shapes": {
        "flash_attention": [B, Hq, Hkv, S_pre, S_pre, D],
        "flash_attention:decode": [B, Hq, Hkv, 1, L, D, pos_dec],
        "ssd_scan": [B, S_m, H, P, N, Q]}}))
    return rows


# ------------------------------------------------- the private LP solvers

LP_M_LOG2, LP_D = 18, 20     # scalar LP: benchmarks/bench_lp.py:9, 38
DUAL_M, DUAL_D, DUAL_S = 300, 1024, 12   # dual LP: benchmarks/bench_lp.py:79


def dual_opt(b, c) -> float:
    """The dual's OPT level: twice c_min·b_max, so its width
    ρ = OPT/c_min − b_max is b_max. (The reference's benchmark takes
    OPT = ½·mean(c), which floors ρ at 1e-6; the reference then turns its
    y to NaN on the CPU and picks vertex 0 from the second step on.)"""
    return 2.0 * float(np.min(c)) * float(np.max(b))


def k7_edge_shapes(dev, g, expect) -> None:
    """K7 against its plain version on each route of `plan` (``warp`` up to
    WARP_U, ``block`` up to BLOCK_U, ``grid`` past it): U at every boundary
    of the routes, of the warp route's values a lane and of the grid's
    blocks a row (GRID_TILE · GRID_BLOCKS_PER_SM · SMs, where a block
    starts to take two tiles), each ±1, rows not a multiple of 4, one row
    and 8-row grids, three steps, a dense update and one picked by row id.
    lw' to rtol 1e-6 (the kernel rounds the product and the sum as the
    plain version does), m exactly, s and p to rtol 1e-5 (a sum in another
    order); two identical calls agree bit for bit, and a single-row call
    equals its row of the grid."""
    import torch
    from repro_torch.kernels.mwu_update import mwu_update, mwu_update_ref, plan
    from repro_torch.kernels.mwu_update.ops import (BLOCK_U, GRID_BLOCKS_PER_SM,
                                                    GRID_TILE, WARP_U)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    edges = [32, 64, 512, WARP_U, BLOCK_U, GRID_TILE * GRID_BLOCKS_PER_SM * sms]
    sizes = sorted({1, 20, 21, 300, 2 ** 20}
                   | {e + d for e in edges for d in (-1, 0, 1)})
    for U in sizes:
        for B in (1, 8):
            lw, c, table = 3.0 * randn(B, U), randn(B, U), randn(13, U)
            rows = torch.randint(0, 13, (B,), generator=g, device=dev)
            for coef in (-0.37, 0.0, 1.5):
                for form, args in (("dense", (lw, c, coef)),
                                   ("rows", (lw, table, coef, rows))):
                    got, want = mwu_update(*args), mwu_update_ref(*args)
                    again = mwu_update(*args)
                    ok = (torch.allclose(got[0], want[0], rtol=1e-6, atol=0)
                          and torch.equal(got[2], want[2])
                          and torch.allclose(got[3], want[3], rtol=1e-5, atol=0)
                          and torch.allclose(got[1], want[1], rtol=1e-5,
                                             atol=1e-30)
                          and all(torch.equal(a, b) for a, b in zip(got, again)))
                    err = max(float((a - b).abs().max()) for a, b in zip(got, want))
                    expect(ok, f"mwu_update U={U} B={B} coef={coef} {form} "
                           f"{plan(U)}: max err {err}")
            one = mwu_update(lw[B - 1], table, -0.37, rows=rows[B - 1])
            grid = mwu_update(lw, table, -0.37, rows=rows)
            expect(all(torch.equal(a, b[B - 1]) for a, b in zip(one, grid)),
                   f"mwu_update U={U}: a single row differs from its grid row")
    torch.cuda.synchronize()


def k3_edge_cases(dev, g, expect) -> None:
    """K3 against its plain version on each route of `score_plan`
    (``narrow`` up to NARROW_U, ``split`` into SEG-float segments past it):
    U at every boundary ±1 (the narrow route's, one and two segments, the
    main path's 2**14 and one float past it), rows not a multiple of 4
    (scalar loads), rows picked by augmented id on both signs, C = 0, 1, 5
    and 300 slots, at random, none, only the last and all active, on 1, 8
    and 33 lanes, and one-segment tails of a slot a warp of the grid ±1
    (where the split route stops giving each warp its own slot and scans
    the flags); the score within `f32_tol`, inactive slots exactly 0, two
    identical calls equal bit for bit and each lane of a wave equal to the
    single-lane call on its row."""
    import torch
    from repro_torch.kernels.mwem_step import (NARROW_U, SEG, gather_score,
                                               gather_score_batch,
                                               gather_score_batch_ref,
                                               score_plan)

    m = 37
    warps = 8 * torch.cuda.get_device_properties(dev).multi_processor_count
    sizes = sorted({1, 4, 21, 300, U, U + 1}
                   | {e + d for e in (NARROW_U, SEG, 2 * SEG) for d in (-1, 0, 1)})
    for u in sizes:
        Qs = torch.randn(m, u, generator=g, device=dev)
        for lanes in (1, LANES, 33):
            V = torch.randn(lanes, u, generator=g, device=dev)
            tol = f32_tol(u, float((Qs.abs() @ V.abs().T).max()))
            counts = (0, 1, 5, 300)
            if lanes == 1 and u in (300, 301):
                counts += (warps - 1, warps, warps + 1)
            for C in counts:
                aug = torch.randint(0, 2 * m, (lanes, C), generator=g, device=dev)
                cases = {"random": torch.rand(lanes, C, generator=g, device=dev) < 0.3,
                         "none": torch.zeros(lanes, C, dtype=torch.bool, device=dev),
                         "last": torch.arange(C, device=dev).expand(lanes, C) == C - 1,
                         "all": None}
                for kind, act in cases.items():
                    act = None if act is None else act.contiguous()
                    got = gather_score_batch(Qs, V, aug, act)
                    again = gather_score_batch(Qs, V, aug, act)
                    want = gather_score_batch_ref(Qs, V, aug, act)
                    err = float((got - want).abs().max()) if C else 0.0
                    ok = err <= tol and torch.equal(got, again)
                    if act is not None:
                        ok = ok and float(got[~act].abs().sum()) == 0.0
                    for b in sorted({0, lanes - 1}):
                        one = gather_score(Qs, V[b], aug[b],
                                           None if act is None else act[b])
                        ok = ok and torch.equal(one, got[b])
                    expect(ok, f"gather_score U={u} {score_plan(u)} lanes={lanes} "
                           f"C={C} active={kind}: max err {err} (tol {tol})")
    torch.cuda.synchronize()


def lp_width_shapes(dev, g, expect) -> None:
    """K1 (``plain``), K3 and K4 at the LP paths' widths — 21 (the rows
    ``[A_i, b_i]``) and 300 (the dual's N rows) — against their plain
    versions: both widths take the kernels' scalar load path (d % 4 ≠ 0,
    or a probe that is a row of a (B, d + 1) block at an unaligned
    offset)."""
    import torch
    from repro_torch.kernels.ivf_probe import ivf_probe_stream, ivf_probe_stream_ref
    from repro_torch.kernels.mips_topk import mips_topk, mips_topk_ref
    from repro_torch.kernels.mwem_step import (gather_score, gather_score_batch,
                                               gather_score_batch_ref,
                                               gather_score_ref)
    from repro_torch.mips import IVFIndex

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    for n, d, k in ((2 ** LP_M_LOG2, LP_D + 1, 512), (DUAL_D, DUAL_M, 32),
                    (1000, LP_D + 1, 37)):
        V, Qb = randn(n, d), randn(3, d)
        for q in (Qb[1], randn(d)):
            tol = f32_tol(d, float((V.abs() @ q.abs()).max()))
            got, want = mips_topk(V, q, k, "plain"), mips_topk_ref(V, q, k, "plain")
            ok, err = same_topk(*got, *want, tol)
            expect(ok, f"mips_topk plain n={n} d={d} k={k}: max err {err}")
            aug = torch.randint(0, n, (300,), generator=g, device=dev)
            act = torch.rand(300, generator=g, device=dev) < 0.5
            err = float((gather_score(V, q, aug, act)
                         - gather_score_ref(V, q, aug, act)).abs().max())
            expect(err <= tol, f"gather_score n={n} d={d}: max err {err}")
        aug_b = torch.randint(0, n, (3, 300), generator=g, device=dev)
        act_b = torch.rand(3, 300, generator=g, device=dev) < 0.5
        err = float((gather_score_batch(V, Qb, aug_b, act_b)
                     - gather_score_batch_ref(V, Qb, aug_b, act_b)).abs().max())
        expect(err <= f32_tol(d, float((V.abs() @ Qb.abs().T).max())),
               f"gather_score_batch n={n} d={d}: max err {err}")
    for n, d in ((4096, LP_D + 1), (DUAL_D, DUAL_M)):
        index = IVFIndex(randn(n, d).cpu().numpy(), seed=0, device=dev)
        Qb = randn(3, d)
        probe = mips_topk(index._cents, Qb[1], index.nprobe, "plain")[0]
        tol = f32_tol(d, float((index._cell_rows[probe.long()].abs()
                                @ Qb[1].abs()).max()))
        for k in (1, 16, 64):
            got = ivf_probe_stream(probe, index._cell_rows, index._cells8, Qb[1], k)
            want = ivf_probe_stream_ref(probe, index._cell_rows, index._cells8,
                                        Qb[1], k)
            ok, err = same_topk(got[0], got[1], want[0], want[1], tol)
            expect(ok and int(got[2]) == int(want[2]),
                   f"ivf_probe n={n} d={d} k={k}: max err {err}")
    torch.cuda.synchronize()


def small_lp_card_vs_cpu(dev, seed, expect) -> None:
    """Both LP solvers and the LP wave on a small instance, card against
    CPU with the same numpy draws: the same selections and n_scored, x̄
    within 1e-6 (a distribution over 20 or 256 entries); each card lane of
    a wave equals the card's single-lane solve."""
    import torch
    from repro_torch.core import (DualLPConfig, ScalarLPConfig,
                                  solve_constraint_private_lp, solve_lp_batch,
                                  solve_scalar_lp)
    from repro_torch.core.queries import random_feasible_lp, random_packing_lp
    from repro_torch.mips import FlatIndex, IVFIndex, lp_dual_rows, lp_scalar_rows

    cpu = torch.device("cpu")
    rng = np.random.default_rng([seed, 30])
    A, b, _ = random_feasible_lp(rng, 2048, LP_D)
    rows = lp_scalar_rows(A, b)

    def index_on(kind, where, V):
        if kind == "flat":
            return FlatIndex(V, device=where)
        return IVFIndex(V, seed=0, device=where) if kind == "ivf" else None

    def same(a, b_):
        return (list(a.selected) == list(b_.selected)
                and list(a.n_scored) == list(b_.n_scored)
                and torch.allclose(a.x_bar.cpu(), b_.x_bar.cpu(), rtol=0,
                                   atol=1e-6))

    for kind in ("exact", "flat", "ivf"):
        cfg = ScalarLPConfig(T=40, mode="exact" if kind == "exact" else "fast")
        card, host = (solve_scalar_lp(A, b, cfg, NumpyDraws(seed + 31),
                                      index=index_on(kind, where, rows),
                                      device=where) for where in (dev, cpu))
        expect(same(card, host), f"small scalar LP {kind}: card and CPU differ")
    bb = np.stack([b + 0.05 * rng.standard_normal(b.shape[0]).astype(np.float32)
                   for _ in range(3)])
    for kind, bw in (("flat", b), ("exact", bb)):
        cfg = ScalarLPConfig(T=40, mode="exact" if kind == "exact" else "fast")
        waves = [solve_lp_batch(A, bw, cfg,
                                [NumpyDraws(seed + 32 + lane) for lane in range(3)],
                                index=index_on(kind, where, rows), device=where)
                 for where in (dev, cpu)]
        ok = (np.array_equal(waves[0].selected, waves[1].selected)
              and np.array_equal(waves[0].n_scored, waves[1].n_scored)
              and torch.allclose(waves[0].x_bar.cpu(), waves[1].x_bar, atol=1e-6))
        expect(ok, f"small LP wave {kind}: card and CPU differ")
        for lane in range(3):
            one = solve_scalar_lp(A, bw if bw.ndim == 1 else bw[lane], cfg,
                                  NumpyDraws(seed + 32 + lane),
                                  index=index_on(kind, dev, rows), device=dev)
            expect(one.selected == waves[0].selected[lane].tolist(),
                   f"small LP wave {kind}: card lane {lane} differs from "
                   f"its single-lane solve")
    A2, b2, c2 = random_packing_lp(rng, 120, 256)
    opt = dual_opt(b2, c2)
    N = lp_dual_rows(A2, c2, opt)
    for kind in ("exact", "flat", "ivf"):
        cfg = DualLPConfig(T=40, s=DUAL_S,
                           mode="exact" if kind == "exact" else "fast")
        card, host = (solve_constraint_private_lp(
            A2, b2, c2, opt, cfg, NumpyDraws(seed + 36),
            index=index_on(kind, where, N), device=where)
            for where in (dev, cpu))
        expect(same(card, host) and card.n_violated == host.n_violated,
               f"small dual LP {kind}: card and CPU differ")


def lp_main_path(args, dev, expect, ops) -> dict:
    """The LP paths at the paper's sizes: the scalar solver at m = 2**18,
    d = 20, T = ``--lp-T`` in exact, fast/flat and fast/IVF mode; waves of
    8 lanes (fast/flat, and exact with one b a lane); the dual at
    (m, d) = (300, 1024), s = 12, in exact and fast/flat mode. Counts are
    zeroed before each run and read after it; K7 must launch once an
    iteration of each solve or wave. Returns what the timing rows need."""
    import torch
    from repro_torch.core import (DualLPConfig, LaneDraws, PrivacyLedger,
                                  ScalarLPConfig, TorchDraws, lp_release_cost,
                                  solve_constraint_private_lp, solve_lp_batch,
                                  solve_scalar_lp)
    from repro_torch.core.queries import random_feasible_lp, random_packing_lp
    from repro_torch.mips import FlatIndex, IVFIndex, lp_dual_rows, lp_scalar_rows

    T, m, d = args.lp_T, 2 ** LP_M_LOG2, LP_D
    rng = np.random.default_rng([args.seed, 31])
    t0 = time.perf_counter()
    A_np, b_np, _ = random_feasible_lp(rng, m, d)
    rows_np = lp_scalar_rows(A_np, b_np)
    A, b = torch.as_tensor(A_np).to(dev), torch.as_tensor(b_np).to(dev)
    flat = FlatIndex(rows_np, device=dev)
    t1 = time.perf_counter()
    ivf = IVFIndex(rows_np, seed=args.seed, device=dev)
    torch.cuda.synchronize()
    alpha = ScalarLPConfig().alpha
    uniform_vf = float(((A @ torch.full((d,), 1.0 / d, device=dev) - b)
                        > alpha).float().mean())
    log(json.dumps({"lp_data": {"m": m, "d": d, "T": T,
                                "data_s": t1 - t0,
                                "ivf_build_s": time.perf_counter() - t1,
                                "nlist": ivf.nlist, "cap": ivf.cap,
                                "nprobe": ivf.nprobe,
                                "uniform_violated_frac": uniform_vf}}))
    out = {"A": A, "b": b, "flat": flat, "ivf": ivf, "counts": {}, "runs": {}}

    def check_counts(tag, counts, want):
        expect(counts["mwu_update"] == T,
               f"{tag}: mwu_update launched {counts['mwu_update']} times, not {T}")
        for name in want:
            expect(counts[name] > 0, f"{tag}: kernel {name} never launched")

    expected = {"exact": (), "flat": ("mips_topk", "gather_score_batch"),
                "ivf": ("mips_topk", "ivf_probe", "gather_score_batch")}
    for kind, index in (("exact", None), ("flat", flat), ("ivf", ivf)):
        cfg = ScalarLPConfig(eps=1.0, delta=1e-3, T=T,
                             mode="exact" if kind == "exact" else "fast")
        torch.cuda.synchronize()
        reset_counts(ops)
        t0 = time.perf_counter()
        res = solve_scalar_lp(A, b, cfg, TorchDraws.seeded(args.seed + 40, dev),
                              index=index)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts(ops)
        preview = PrivacyLedger().preview(*lp_release_cost(cfg, A, index))
        composed = res.ledger.composed()
        log(json.dumps({"lp_run": kind, "violated_frac": res.violated_frac,
                        "uniform_violated_frac": uniform_vf,
                        "mean_n_scored": float(np.mean(res.n_scored)),
                        "overflow_count": res.overflow_count,
                        "device_ms_per_iter": 1e3 * float(np.mean(res.iter_seconds)),
                        "wall_ms_per_iter": 1e3 * wall / T,
                        "eps_delta": composed, "preview": preview,
                        "launches": counts}))
        x = res.x_bar
        expect(tuple(x.shape) == (d,) and bool(torch.isfinite(x).all())
               and bool((x >= 0).all()) and abs(float(x.sum()) - 1.0) < 1e-4,
               f"lp {kind}: x_bar is not a distribution over {d}")
        expect(0.0 <= res.violated_frac <= 1.0, f"lp {kind}: violated_frac "
               f"{res.violated_frac}")
        expect(composed == preview, f"lp {kind}: ledger {composed} != {preview}")
        check_counts(f"lp {kind}", counts, expected[kind])
        out["counts"][kind], out["runs"][kind] = counts, res

    bb = b[None, :] + 0.05 * torch.randn(LANES, m, device=dev,
                                         generator=torch.Generator(device=dev)
                                         .manual_seed(args.seed + 41))
    for kind, index, bw in (("flat", flat, b), ("exact", None, bb)):
        cfg = ScalarLPConfig(eps=1.0, delta=1e-3, T=T,
                             mode="exact" if kind == "exact" else "fast")
        ledgers = [PrivacyLedger() for _ in range(LANES)]
        draws = LaneDraws.seeded([args.seed + 50 + i for i in range(LANES)], dev)
        torch.cuda.synchronize()
        reset_counts(ops)
        t0 = time.perf_counter()
        res = solve_lp_batch(A, bw, cfg, draws, index=index, ledgers=ledgers)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts(ops)
        preview = PrivacyLedger().preview(*lp_release_cost(cfg, A, index))
        log(json.dumps({"lp_wave": kind, "lanes": LANES,
                        "per_lane_b": bw.dim() == 2,
                        "violated_fracs": res.violated_fracs.tolist(),
                        "mean_n_scored": float(res.n_scored.mean()),
                        "overflow_counts": res.overflow_counts.tolist(),
                        "device_ms_per_iter": 1e3 * res.total_seconds / T,
                        "wall_ms_per_iter": 1e3 * wall / T,
                        "preview": preview, "launches": counts}))
        xs = res.x_bar
        expect(tuple(xs.shape) == (LANES, d) and bool(torch.isfinite(xs).all())
               and bool(((xs.sum(1) - 1.0).abs() < 1e-4).all()),
               f"lp wave {kind}: x_bar malformed")
        expect(all(led.composed() == preview for led in ledgers),
               f"lp wave {kind}: a lane's ledger differs from {preview}")
        expect(len({tuple(r) for r in res.selected}) > 1,
               f"lp wave {kind}: every lane selected the same constraints")
        check_counts(f"lp wave {kind}", counts, expected[kind])
        out["counts"][f"wave {kind}"], out["runs"][f"wave {kind}"] = counts, res

    A2, b2, c2 = random_packing_lp(rng, DUAL_M, DUAL_D)
    opt = dual_opt(b2, c2)
    N_np = lp_dual_rows(A2, c2, opt)
    flat_n = FlatIndex(N_np, device=dev)
    out.update(N=flat_n._v, flat_n=flat_n)
    for kind, index in (("exact", None), ("flat", flat_n)):
        cfg = DualLPConfig(eps=1.0, delta=1e-3, T=T, s=DUAL_S,
                           mode="exact" if kind == "exact" else "fast")
        torch.cuda.synchronize()
        reset_counts(ops)
        t0 = time.perf_counter()
        res = solve_constraint_private_lp(A2, b2, c2, opt, cfg,
                                          TorchDraws.seeded(args.seed + 60, dev),
                                          index=index)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts(ops)
        preview = PrivacyLedger().preview(*lp_release_cost(cfg, A2, index))
        composed = res.ledger.composed()
        objective = float(res.x_bar.cpu() @ torch.as_tensor(c2))
        log(json.dumps({"dual_run": kind, "m": DUAL_M, "d": DUAL_D, "s": DUAL_S,
                        "opt": opt, "objective": objective,
                        "n_violated": res.n_violated,
                        "mean_n_scored": float(np.mean(res.n_scored)),
                        "overflow_count": res.overflow_count,
                        "device_ms_per_iter": 1e3 * float(np.mean(res.iter_seconds)),
                        "wall_ms_per_iter": 1e3 * wall / T,
                        "eps_delta": composed, "preview": preview,
                        "launches": counts}))
        expect(bool(torch.isfinite(res.x_bar).all())
               and abs(objective - opt) <= 1e-3 * opt,
               f"dual {kind}: x_bar is not in K_OPT (c·x̄ = {objective}, OPT {opt})")
        expect(composed == preview, f"dual {kind}: ledger {composed} != {preview}")
        check_counts(f"dual {kind}", counts,
                     () if kind == "exact" else ("mips_topk", "gather_score"))
        out["counts"][f"dual {kind}"], out["runs"][f"dual {kind}"] = counts, res

    # device busy share of 50 iterations of each fast LP path, by profiler
    # (the window runs between the ends of the first and last K7 launch)
    profiled = (
        ("lp flat", lambda: solve_scalar_lp(
            A, b, ScalarLPConfig(T=51), TorchDraws.seeded(args.seed + 80, dev),
            index=flat)),
        ("lp ivf", lambda: solve_scalar_lp(
            A, b, ScalarLPConfig(T=51), TorchDraws.seeded(args.seed + 80, dev),
            index=ivf)),
        ("lp wave flat", lambda: solve_lp_batch(
            A, b, ScalarLPConfig(T=51),
            LaneDraws.seeded([args.seed + 90 + i for i in range(LANES)], dev),
            index=flat)),
        ("dual flat", lambda: solve_constraint_private_lp(
            A2, b2, c2, opt, DualLPConfig(T=51, s=DUAL_S),
            TorchDraws.seeded(args.seed + 80, dev), index=flat_n)),
    )
    for name, run in profiled:
        res, prof = profile_window(run, step_kernel="mwu_warp_kernel")
        event_ms = (1e3 * res.total_seconds / 51 if hasattr(res, "total_seconds")
                    else 1e3 * float(np.mean(res.iter_seconds[1:])))
        log(json.dumps({"profile": name, **prof, "event_iter_ms": event_ms}))
    return out


def lp_timing_rows(lp, dev, seed, expect) -> list:
    """K7 at the LP paths' shapes — the primal's one lane and 8 lanes at
    U = 20 (rows picked by id from A), the dual's one row at U = 300 —
    and at one row of 2**20 (``timing_only``: no path runs it), plus K1,
    K3 and K4 at the LP paths' shapes, each against its plain version
    and timed; K7's yardstick is `torch.softmax` of `torch.add` (two
    calls)."""
    import torch
    from repro_torch.core.lazy_em import default_tail_cap
    from repro_torch.kernels.ivf_probe import ivf_probe_stream, ivf_probe_stream_ref
    from repro_torch.kernels.mips_topk import mips_topk, mips_topk_ref
    from repro_torch.kernels.mwem_step import (gather_score, gather_score_batch,
                                               gather_score_batch_ref,
                                               gather_score_ref, score_plan)
    from repro_torch.kernels.mwu_update import mwu_update, mwu_update_ref, plan

    g = torch.Generator(device=dev).manual_seed(seed + 70)
    A, b, ivf, N = lp["A"], lp["b"], lp["ivf"], lp["N"]
    cnt, runs = lp["counts"], lp["runs"]
    m, d = A.shape
    T = len(runs["exact"].selected)
    coef = -math.sqrt(math.log(d) / T) / float(A.abs().max())
    sel1 = torch.tensor(runs["flat"].selected[-1:], device=dev)
    sel8 = torch.as_tensor(runs["wave flat"].selected[:, -1], device=dev)
    rows = []
    k7 = [  # (row, launches, lw, c, rows)
        ("mwu_update", sum(cnt[k]["mwu_update"] for k in ("exact", "flat", "ivf")),
         torch.randn(1, d, generator=g, device=dev), A, sel1),
        ("mwu_update:wave",
         sum(cnt[k]["mwu_update"] for k in ("wave flat", "wave exact")),
         torch.randn(LANES, d, generator=g, device=dev), A, sel8),
        ("mwu_update:dual",
         sum(cnt[k]["mwu_update"] for k in ("dual exact", "dual flat")),
         torch.randn(DUAL_M, generator=g, device=dev),
         torch.randn(DUAL_M, generator=g, device=dev), None),
        ("mwu_update:2^20", 0, torch.randn(2 ** 20, generator=g, device=dev),
         torch.randn(2 ** 20, generator=g, device=dev), None),
    ]
    for row, n_launch, lw, c, sel in k7:
        B, U = (1, lw.shape[0]) if lw.dim() == 1 else tuple(lw.shape)
        dense = c if sel is None else c.index_select(0, sel)
        got, want = mwu_update(lw, c, coef, sel), mwu_update_ref(lw, c, coef, sel)
        err = max(float((a - e).abs().max()) for a, e in zip(got, want))
        ok = (torch.allclose(got[0], want[0], rtol=1e-6, atol=0)
              and torch.equal(got[2], want[2])
              and torch.allclose(got[1], want[1], rtol=1e-5, atol=1e-30)
              and torch.allclose(got[3], want[3], rtol=1e-5, atol=0))
        expect(ok, f"{row} at its path's shape: max err {err}")
        calls = (lambda: mwu_update(lw, c, coef, sel),
                 lambda: mwu_update_ref(lw, c, coef, sel),
                 lambda: torch.softmax(torch.add(lw, dense, alpha=coef), -1))
        ms, plain_ms, lib_ms = (time_ms(f) for f in calls)
        back = [replayed_ms(f) for f in calls]
        nbytes = 4.0 * 4 * B * U + 8.0 * B + (8.0 * B if sel is not None else 0.0)
        b_ms, b_by = bound_ms(nbytes, 8.0 * B * U)
        route, S = plan(U)
        stages = stage_ms(calls[0])
        log(json.dumps({"stages_ms": row, **stages}))
        want_k = K7_KERNELS[route]
        expect(set(stages) == want_k,
               f"{row}: one call launched {sorted(stages)}, not {sorted(want_k)}")
        out = {"name": row, "route": "cuda", "source": SOURCES["mwu_update"],
               "replaces": REPLACES["mwu_update"], "launches": n_launch,
               "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
               "library": "torch.softmax(torch.add(lw, c, alpha=coef), -1): "
                          "two calls", "shape": [B, U],
               "mode": route if S == 1 else f"{route}:{S}",
               "replayed_ms": dict(zip(("kernel", "plain", "library"), back))}
        if row in TIMING_ONLY:
            log(json.dumps({"timing_only": out}))
        else:
            rows.append(out)
        log(f"{row} ({B}, {U}) [{out['mode']}]: {ms:.4f} ms (plain {plain_ms:.4f} ms, "
            f"library {lib_ms:.4f} ms in two calls, bound {b_ms:.6f} ms by {b_by}; "
            f"back-to-back {back[0]:.4f} / {back[1]:.4f} / {back[2]:.4f} ms), "
            f"max err {err:.3g}, launches {n_launch}")

    # K1, K3 and K4 where the LP paths run them: a probe [x, -1] from the
    # flat run, a tail with as many active slots as that run's mean tail
    Ab = torch.cat([A, b[:, None]], dim=1)
    xq = torch.cat([runs["flat"].x_bar, torch.full((1,), -1.0, device=dev)])
    k = math.ceil(math.sqrt(m))
    cap = default_tail_cap(m)
    n_act = max(1, round(float(np.mean(runs["flat"].n_scored)) - k))
    aug = torch.randint(0, m, (LANES, cap), generator=g, device=dev)
    act = torch.zeros(LANES, cap, dtype=torch.bool, device=dev)
    act[:, :n_act] = True
    Xq = torch.cat([runs["wave flat"].x_bar,
                    torch.full((LANES, 1), -1.0, device=dev)], dim=1)
    probe = mips_topk(ivf._cents, xq, ivf.nprobe, "plain")[0]
    n_valid = int(ivf_probe_stream(probe, ivf._cell_rows, ivf._cells8, xq, k)[2])
    y = runs["dual flat"].x_bar.new_full((DUAL_M,), 1.0 / DUAL_M)
    kd, capd = math.ceil(math.sqrt(DUAL_D)), default_tail_cap(DUAL_D)
    n_act_d = max(1, round(float(np.mean(runs["dual flat"].n_scored)) - kd))
    aug_d = torch.randint(0, DUAL_D, (capd,), generator=g, device=dev)
    act_d = torch.arange(capd, device=dev) < n_act_d
    dp = d + 1
    cases = [  # (row, wrapper, launches, kernel, plain, tol, bytes, flops)
        ("mips_topk:lp", "mips_topk",
         cnt["flat"]["mips_topk"] + cnt["wave flat"]["mips_topk"],
         lambda: mips_topk(Ab, xq, k, "plain"),
         lambda: mips_topk_ref(Ab, xq, k, "plain"),
         f32_tol(dp, float((Ab.abs() @ xq.abs()).max())),
         4.0 * m * dp + 4 * dp + 8 * k, 2.0 * m * dp),
        ("ivf_probe:lp", "ivf_probe", cnt["ivf"]["ivf_probe"],
         lambda: ivf_probe_stream(probe, ivf._cell_rows, ivf._cells8, xq, k),
         lambda: ivf_probe_stream_ref(probe, ivf._cell_rows, ivf._cells8, xq, k),
         f32_tol(dp, float((ivf._cell_rows[probe.long()].abs() @ xq.abs()).max())),
         4.0 * n_valid * dp + 4 * ivf.nprobe * (ivf._cells8.shape[1] + 1)
         + 4 * dp + 8 * k, 2.0 * n_valid * dp),
        ("gather_score_batch:lp", "gather_score_batch",
         sum(cnt[kk]["gather_score_batch"] for kk in ("flat", "ivf", "wave flat")),
         lambda: gather_score_batch(Ab, Xq, aug, act),
         lambda: gather_score_batch_ref(Ab, Xq, aug, act),
         f32_tol(dp, float((Ab.abs() @ Xq.abs().T).max())),
         4.0 * LANES * n_act * dp + 4 * LANES * dp + 9 * LANES * cap
         + 4 * LANES * cap, 2.0 * LANES * n_act * dp),
        ("mips_topk:dual", "mips_topk", cnt["dual flat"]["mips_topk"],
         lambda: mips_topk(N, y, kd, "plain"),
         lambda: mips_topk_ref(N, y, kd, "plain"),
         f32_tol(DUAL_M, float((N.abs() @ y.abs()).max())),
         4.0 * DUAL_D * DUAL_M + 4 * DUAL_M + 8 * kd, 2.0 * DUAL_D * DUAL_M),
        ("gather_score:dual", "gather_score", cnt["dual flat"]["gather_score"],
         lambda: gather_score(N, y, aug_d, act_d),
         lambda: gather_score_ref(N, y, aug_d, act_d),
         f32_tol(DUAL_M, float((N.abs() @ y.abs()).max())),
         4.0 * n_act_d * DUAL_M + 4 * DUAL_M + 13 * capd,
         2.0 * n_act_d * DUAL_M),
    ]
    library = {  # K1's yardstick, as for the main path's rows
        "mips_topk:lp": lambda: torch.topk(torch.mv(Ab, xq), k),
        "mips_topk:dual": lambda: torch.topk(torch.mv(N, y), kd),
    }
    for row, name, n_launch, kern, plain, tol, nbytes, flops in cases:
        got, want = kern(), plain()
        if "gather_score" in name:
            err = float((got - want).abs().max())
            ok = err <= tol
        else:
            ok, err = same_topk(got[0], got[1], want[0], want[1], tol)
            if name == "ivf_probe":
                ok = ok and int(got[2]) == int(want[2])
        expect(ok, f"{row} at its path's shape: max err {err} (tol {tol})")
        ms, plain_ms = time_ms(kern), time_ms(plain)
        lib_ms = time_ms(library[row]) if row in library else None
        b_ms, b_by = bound_ms(nbytes, flops)
        out = {"name": row, "route": "cuda", "source": SOURCES[name],
               "replaces": REPLACES[name], "launches": n_launch,
               "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}
        if lib_ms is not None:
            out["library"] = "torch.topk(torch.mv(V, q), k): two calls"
        out["replayed_ms"] = {"kernel": replayed_ms(kern),
                              "plain": replayed_ms(plain),
                              "library": replayed_ms(library[row])
                              if row in library else None}
        if "gather_score" in name:
            out["mode"] = score_route(score_plan(dp if row.endswith(":lp")
                                                 else DUAL_M))
            check_score_stages(row, kern, out["mode"], expect)
        rows.append(out)
        if row == "mips_topk:lp":
            log(json.dumps({"stages_ms": row, **stage_ms(kern)}))
        tag = f" [{out['mode']}]" if "mode" in out else ""
        log(f"{row}{tag}: {ms:.4f} ms (plain {plain_ms:.4f} ms, library "
            f"{'none' if lib_ms is None else f'{lib_ms:.4f} ms'}, bound "
            f"{b_ms:.4f} ms by {b_by}), max err {err:.3g}, launches {n_launch}"
            f"{'; back to back ' + json.dumps(out['replayed_ms']) if 'replayed_ms' in out else ''}")
    return rows


def lp_phases(args, dev, g, expect, ops) -> list:
    """Step 10: the private LP solvers. Returns their kernel rows."""
    k7_edge_shapes(dev, g, expect)
    lp_width_shapes(dev, g, expect)
    log(f"LP kernel edge shapes: {'ok' if not expect.failures else 'FAILED'}")
    small_lp_card_vs_cpu(dev, args.seed, expect)
    log(f"small LPs, card vs CPU: {'ok' if not expect.failures else 'FAILED'}")
    lp = lp_main_path(args, dev, expect, ops)
    log(f"LP main path: {'ok' if not expect.failures else 'FAILED'}")
    return lp_timing_rows(lp, dev, args.seed, expect)


def wide_ivf_waves(dev, seed, Qs_np, hs_np, expect, ops) -> None:
    """IVF waves of 17 and 24 lanes — more than one K5 launch scores — on
    the small input: every lane equals the card's single-lane `run_mwem`
    with its draws, and K5 ran once a 16-lane group an iteration."""
    from repro_torch.core import MWEMConfig, run_mwem, run_mwem_batch
    from repro_torch.kernels.ivf_probe import MAX_LANES
    from repro_torch.mips import IVFIndex, augment_complement

    index = IVFIndex(augment_complement(Qs_np), seed=0, device=dev)
    cfg = MWEMConfig(T=30, mode="fast", n_records=500)
    for lanes in (17, 24):
        reset_counts(ops)
        res = run_mwem_batch(Qs_np, hs_np, cfg,
                             [NumpyDraws(seed + 300 + b) for b in range(lanes)],
                             index=index)
        n5 = read_counts(ops)["ivf_probe_batch"]
        expect(n5 == cfg.T * -(-lanes // MAX_LANES),
               f"IVF wave B={lanes}: K5 launched {n5} times")
        for lane, r in enumerate(res.unbatch()):
            one = run_mwem(Qs_np, hs_np, cfg, NumpyDraws(seed + 300 + lane),
                           index=index)
            expect(r.selected == one.selected and r.n_scored == one.n_scored,
                   f"IVF wave B={lanes}: lane {lane} differs from its "
                   f"single-lane run")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--T", type=int, default=500,
                    help="iterations of the MWEM main paths, dense and factored")
    ap.add_argument("--m-log2", type=int, default=16)
    ap.add_argument("--n-records", type=int, default=100_000)
    ap.add_argument("--attrs", type=int, default=15,
                    help="binary attributes of the factored main path")
    ap.add_argument("--lp-T", type=int, default=200,
                    help="iterations of each LP solve (benchmarks/bench_lp.py:39)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from repro_torch.core import (AdaptiveConfig, LaneDraws, MWEMConfig,
                                  MarginalWorkload, PrivacyLedger, TorchDraws,
                                  release_cost, run_adaptive_marginals,
                                  run_mwem, run_mwem_batch)
    from repro_torch.core.queries import (gaussian_histogram, max_error,
                                          random_binary_queries)
    from repro_torch.kernels import _build
    from repro_torch.kernels.ivf_probe import (batch_probe_slots,
                                               ivf_probe_stream,
                                               ivf_probe_stream_batch,
                                               ivf_probe_stream_batch_ref,
                                               ivf_probe_stream_ref)
    from repro_torch.kernels.ivf_probe.ops import wave_plan
    from repro_torch.kernels.mips_topk import mips_topk, mips_topk_ref
    from repro_torch.kernels.mwem_step import (CLUSTER_U, MAX_U,
                                               gather_score,
                                               gather_score_batch,
                                               gather_score_batch_ref,
                                               gather_score_ref,
                                               marginal_gather_score,
                                               marginal_gather_score_ref,
                                               mwem_step, mwem_step_batch,
                                               mwem_step_batch_ref,
                                               mwem_step_ref, plan, score_plan)
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.mwu_update import mwu_update
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.mips import (FlatAbsIndex, IVFIndex, MarginalIVFIndex,
                                  augment_complement)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    ops = {"mips_topk": mips_topk, "ivf_probe": ivf_probe_stream,
           "mwem_step": mwem_step, "gather_score": gather_score,
           "ivf_probe_batch": ivf_probe_stream_batch,
           "mwem_step_batch": mwem_step_batch,
           "gather_score_batch": gather_score_batch,
           "marginal_gather_score": marginal_gather_score,
           "flash_attention": flash_attention, "ssd_scan": ssd_scan,
           "mwu_update": mwu_update}
    failures: list[str] = []

    def expect(cond: bool, what: str) -> None:
        if not cond:
            failures.append(what)
            log(f"FAIL: {what}")

    expect.failures = failures

    t_start = time.perf_counter()
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
    k3_edge_cases(dev, g, expect)
    log(f"K3 edge cases: {'ok' if not failures else 'FAILED'}")
    k1_edge_cases(dev, g, expect)
    log(f"K1 select edge cases: {'ok' if not failures else 'FAILED'}")
    lm_edge_shapes(dev, g, expect)
    log(f"LM kernel edge shapes: {'ok' if not failures else 'FAILED'}")

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
    k5_edge_cases(dev, g, expect)
    log(f"K5 edge cases: {'ok' if not failures else 'FAILED'}")

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
    wide_ivf_waves(dev, args.seed, Qs_np, hs_np, expect, ops)
    log(f"IVF waves of 17 and 24 lanes: {'ok' if not failures else 'FAILED'}")

    # ------------------- factored kernels at edge shapes: K6, K2 past 16384
    def k6_case(card, cliques, C, signs="both", active_frac=None):
        """K6 against its plain version; the tolerance is `f32_tol` on each
        candidate's Σ|v| over its row."""
        W = MarginalWorkload(card, cliques, device=dev)
        v = randn(W.U) * 1e-3
        aug = torch.randint(0, W.m, (C,), generator=g, device=dev)
        if signs == "both":
            aug = aug + W.m * torch.randint(0, 2, (C,), generator=g, device=dev)
        elif signs == "minus":
            aug = aug + W.m
        active = None
        if active_frac is not None:
            active = torch.rand(C, generator=g, device=dev) < active_frac
        got = marginal_gather_score(W, v, aug, active)
        want = marginal_gather_score_ref(W, v, aug, active)
        mag = marginal_gather_score_ref(W, v.abs(), aug % W.m)
        err = float((got - want).abs().max()) if C else 0.0
        ok = err <= f32_tol(W.U, float(mag.max()) if C else 0.0)
        if active is not None:
            ok = ok and float(got[~active].abs().sum()) == 0.0
        expect(ok, f"marginal_gather_score card={card[:6]} U={W.U} "
               f"kmax={W.kmax} C={C} {signs} active={active_frac}: max err {err}")

    hetero = (3, 5, 7, 2)                                   # U = 210
    k6_case(hetero, [(0,), (1,), (2,), (3,)], 40)           # kmax 1
    k6_case(hetero, [(0, 2), (3,), (1, 2, 3), (0, 1)], 60)  # padded arities
    k6_case(hetero, [(0, 1, 2, 3), (2,), (1, 3)], 80, active_frac=0.5)
    k6_case(hetero, [(0, 1, 2, 3)], 1)                       # C = 1
    k6_case(hetero, [(0, 1), (2, 3)], 50, active_frac=0.0)   # nothing active
    k6_case(hetero, [(0, 1), (1, 2, 3)], 50, signs="minus")
    k6_case((4, 3, 5, 6, 7, 3), [(0, 5), (1, 2, 4), (3,), (0, 1, 2, 3)], 200,
            active_frac=0.3)                                 # U = 7560
    k6_case(hetero, [(3, 1, 0), (2, 0), (3, 2, 1, 0)], 80)  # descending order
    k6_case((4, 3, 5, 6, 7, 3), [(5, 4, 3, 2, 1, 0), (2, 5)], 60)  # all attributes
    k6_case((2, 1, 3, 1, 4), [(1, 3), (0, 1, 4), (3, 2)], 30)  # cards of 1
    k6_case((2,) * 15, list(itertools.combinations(range(15), 4))[:300], 836,
            active_frac=0.25)                                # U = 2**15
    k6_case((2,) * 15, list(itertools.combinations(range(15), 4)), 836)  # main, all active
    k6_case((2,) * 16, list(itertools.combinations(range(16), 4))[::9], 300,
            active_frac=0.5)                                 # U = 2**16
    for u in (MAX_U + 1, CLUSTER_U, CLUSTER_U + 1, 65536, 100_000, 131072,
              131073):
        Qs = (torch.rand(9, u, generator=g, device=dev) < 0.3).float()
        lw = randn(LANES, u)
        lw = lw - lw.amax(1, keepdim=True)
        p = torch.softmax(lw, 1)
        ps = torch.rand(LANES, u, generator=g, device=dev)
        hb = torch.softmax(randn(LANES, u), 1)
        sel = torch.randint(0, 9, (LANES,), generator=g, device=dev)
        noise = 1e-3 * randn(LANES)
        for rule in ("paper", "signed", "hardt"):
            reset_counts(ops)
            got = mwem_step(lw[0], p[0], ps[0], Qs, sel[0], hb[0], noise[0],
                            rule=rule, eta=0.3)
            again = mwem_step(lw[0], p[0], ps[0], Qs, sel[0], hb[0], noise[0],
                              rule=rule, eta=0.3)
            want = mwem_step_ref(lw[0], p[0], ps[0], Qs, sel[0], hb[0],
                                 noise[0], rule=rule, eta=0.3)
            ok = all(torch.allclose(a, b, rtol=1e-4, atol=1e-7)
                     for a, b in zip(got, want))
            ok = ok and all(torch.equal(a, b) for a, b in zip(got, again))
            # both calls past U = 16384; one cluster launch each up to its reach
            ok = ok and mwem_step.launches_multiblock == 2
            ok = ok and mwem_step.launches_cluster == (2 if u <= CLUSTER_U else 0)
            expect(ok, f"mwem_step u={u} {rule} ({plan(u, 1)})")
            for hh in (hb[0], hb):
                got = mwem_step_batch(lw, p, ps, Qs, sel, hh, noise, rule=rule,
                                      eta=0.3)
                want = mwem_step_batch_ref(lw, p, ps, Qs, sel, hh, noise,
                                           rule=rule, eta=0.3)
                ok = all(torch.allclose(a, b, rtol=1e-4, atol=1e-7)
                         for a, b in zip(got, want))
                for b in range(LANES):  # lane b is the single-lane launch
                    one = mwem_step(lw[b], p[b], ps[b], Qs, sel[b],
                                    hh if hh.dim() == 1 else hh[b], noise[b],
                                    rule=rule, eta=0.3)
                    ok = ok and all(torch.equal(a[b], c) for a, c in zip(got, one))
                ok = ok and bool(torch.allclose(got[1].sum(1), torch.ones(
                    LANES, device=dev), atol=1e-5))
                expect(ok, f"mwem_step_batch u={u} {rule} "
                       f"h{tuple(hh.shape)}")
    torch.cuda.synchronize()
    log(f"factored edge shapes: {'ok' if not failures else 'FAILED'}")

    # ------------------------------- small factored release, card vs CPU
    small_card, small_cl = (3, 2, 4, 2, 3), [
        (0, 1), (0, 2), (1, 3), (2, 4), (3, 4), (1,), (0, 2, 4), (1, 2, 3)]
    rng_f = np.random.default_rng([args.seed, 3])
    h_small = rng_f.dirichlet(np.full(144, 0.4)).astype(np.float32)
    for kind in ("exact", "flat", "mivf"):
        cfg = MWEMConfig(T=30, mode="exact" if kind == "exact" else "fast",
                         n_records=2000)
        pair = []
        for where in (dev, torch.device("cpu")):
            Wf = MarginalWorkload(small_card, small_cl, device=where)
            index = None
            if kind == "flat":
                index = FlatAbsIndex(Wf, device=where)
            elif kind == "mivf":
                index = MarginalIVFIndex(Wf, device=where)
            pair.append(run_mwem(Wf, h_small, cfg, NumpyDraws(args.seed + 3),
                                 index=index, device=where))
        a, b = pair
        same = (a.selected == b.selected and a.n_scored == b.n_scored
                and torch.allclose(a.p_hat.cpu(), b.p_hat, rtol=1e-4, atol=1e-7))
        expect(same, f"small factored {kind} release: card and CPU runs differ")
    log(f"small factored releases: {'ok' if not failures else 'FAILED'}")

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
    launches = dict.fromkeys(read_counts(ops), 0)
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
        counts = read_counts(ops)
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
        counts = read_counts(ops)
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

    # ------------------- factored main path: all 4-way marginals, one lane
    t0 = time.perf_counter()
    Wm = MarginalWorkload.all_kway((2,) * args.attrs, 4, device=dev)
    rng_m = np.random.default_rng([args.seed, 4])
    logits = 2.0 * rng_m.standard_normal(Wm.U)
    p_true = np.exp(logits - logits.max())
    h_m = torch.as_tensor(
        (rng_m.multinomial(n_rec, p_true / p_true.sum()) / n_rec).astype(
            np.float32)).to(dev)
    uniform_m = float(Wm.max_err(h_m, torch.full((Wm.U,), 1.0 / Wm.U,
                                                 device=dev)))
    mivf = MarginalIVFIndex(Wm, device=dev)
    torch.cuda.synchronize()
    log(json.dumps({"factored_workload": {
        "cliques": Wm.n_cliques, "m": Wm.m, "U": Wm.U, "kmax": Wm.kmax,
        "dense_nbytes_avoided": Wm.dense_nbytes, "factored_nbytes": Wm.nbytes,
        "nprobe": mivf.nprobe, "uniform_error": uniform_m,
        "setup_s": time.perf_counter() - t0}}))
    expected_f = {"exact": {"mwem_step", "mwem_step:cluster"},
                  "flat": {"marginal_gather_score", "mwem_step",
                           "mwem_step:cluster"},
                  "mivf": {"marginal_gather_score", "mwem_step",
                           "mwem_step:cluster"}}
    fruns, fcounts = {}, {}
    for kind, index in (("exact", None), ("flat", FlatAbsIndex(Wm, device=dev)),
                        ("mivf", mivf)):
        cfg = MWEMConfig(eps=1.0, delta=1e-3, T=T, n_records=n_rec,
                         mode="exact" if kind == "exact" else "fast")
        torch.cuda.synchronize()
        reset_counts(ops)
        t0 = time.perf_counter()
        res = run_mwem(Wm, h_m, cfg, TorchDraws.seeded(args.seed + 5, dev),
                       index=index)
        wall = time.perf_counter() - t0
        counts = read_counts(ops)
        fcounts[kind] = counts
        for name, c in counts.items():
            launches[name] += c
        fruns[kind] = res
        preview = PrivacyLedger().preview(*release_cost(cfg, Wm.m, Wm.U, index))
        composed = res.ledger.composed()
        log(json.dumps({"factored_run": kind, "final_error": res.final_error,
                        "uniform_error": uniform_m,
                        "mean_n_scored": float(np.mean(res.n_scored)),
                        "overflow_count": res.overflow_count,
                        "eps_delta": composed, "preview": preview,
                        "wall_s": wall,
                        "mean_iter_ms": 1e3 * float(np.mean(res.iter_seconds)),
                        "launches": counts}))
        expect(math.isfinite(res.final_error) and res.final_error < uniform_m,
               f"factored {kind}: error {res.final_error} not below uniform "
               f"{uniform_m}")
        expect(bool(torch.isfinite(res.p_hat).all())
               and tuple(res.p_hat.shape) == (Wm.U,)
               and abs(float(res.p_hat.sum()) - 1.0) < 1e-4,
               f"factored {kind}: p_hat malformed")
        expect(composed == preview,
               f"factored {kind}: ledger {composed} != {preview}")
        for name in expected_f[kind]:
            expect(counts[name] > 0,
                   f"factored {kind}: kernel {name} never launched")
        expect(counts["mwem_step:cluster"] == counts["mwem_step:multiblock"]
               == counts["mwem_step"],
               f"factored {kind}: a K2 step at U={Wm.U} took more than one "
               f"cluster launch: {counts}")

    # the adaptive worst-marginal loop on the same workload
    cfg_a = AdaptiveConfig(eps=1.0, delta=1e-3, T=30, n_records=n_rec)
    led = PrivacyLedger()
    t0 = time.perf_counter()
    ad = run_adaptive_marginals(Wm, h_m, cfg_a,
                                TorchDraws.seeded(args.seed + 6, dev), ledger=led)
    ad_err = float(ad.final_error)
    log(json.dumps({"adaptive": {"T": cfg_a.T, "final_error": ad_err,
                                 "uniform_error": uniform_m,
                                 "n_scored": ad.n_scored,
                                 "eps_delta": [ad.eps_spent, ad.delta_spent],
                                 "wall_s": time.perf_counter() - t0}}))
    expect(math.isfinite(ad_err) and tuple(ad.selected.shape) == (cfg_a.T,),
           f"adaptive: error {ad_err} or selections malformed")
    expect([e[2] for e in led.events]
           == ["adaptive_em", "adaptive_measure"] * cfg_a.T
           and led.composed() == (ad.eps_spent, ad.delta_spent),
           "adaptive: ledger differs from its events")

    for kind, index in (("exact", None), ("flat", FlatAbsIndex(Wm, device=dev)),
                        ("mivf", mivf)):
        cfg = MWEMConfig(T=51, n_records=n_rec,
                         mode="exact" if kind == "exact" else "fast")
        res, prof = profile_window(
            lambda: run_mwem(Wm, h_m, cfg, TorchDraws.seeded(args.seed + 7, dev),
                             index=index))
        log(json.dumps({"profile": f"factored {kind}", **prof, "event_iter_ms":
                        1e3 * float(np.mean(res.iter_seconds[1:]))}))

    # ------------------------------- kernels at the main path's shapes
    p = torch.softmax(torch.zeros(U, device=dev), 0)
    v = h - runs["flat"].p_hat
    k = math.ceil(math.sqrt(m))
    tail_cap = 4 * math.ceil(math.sqrt(2 * m))
    rows_gen = torch.Generator(device=dev).manual_seed(args.seed + 7)
    aug = torch.randint(0, 2 * m, (tail_cap,), generator=rows_gen, device=dev)
    # the tail's active slots are a prefix, as many as the flat run's mean tail
    n_act = min(tail_cap, max(1, round(float(np.mean(runs["flat"].n_scored)) - k)))
    active = torch.arange(tail_cap, device=dev) < n_act
    probe, _ = mips_topk(ivf._cents, v, ivf.nprobe, "plain")
    n_valid = int(ivf_probe_stream(probe, ivf._cell_rows, ivf._cells8, v, k)[2])
    sel = torch.tensor(runs["flat"].selected[-1], device=dev)
    noise = torch.tensor(1e-3, device=dev)
    lw0 = torch.zeros(U, device=dev)
    ps0 = runs["flat"].p_hat.clone()
    vq = float((Q.abs() @ v.abs()).max())
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
        ("mwem_step", "mwem_step", "cluster:%d" % plan(U, 1)[1],  # U <= 16384
         launches["mwem_step"] - launches["mwem_step:multiblock"],
         lambda: mwem_step(lw0, p, ps0, Q, sel, h, noise, rule="hardt",
                           eta=math.sqrt(math.log(U) / T)),
         lambda: mwem_step_ref(lw0, p, ps0, Q, sel, h, noise, rule="hardt",
                               eta=math.sqrt(math.log(U) / T)),
         None, 4.0 * 8 * U + 16, 12.0 * U),
        ("gather_score", "gather_score", score_route(score_plan(U)),
         launches["gather_score"],
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
    # K5's grid: (blocks a split, splits); an item is a slot's chunk of rows,
    # busy when it holds a valid row (the unique slots come first)
    wp = wave_plan(slots.numel(), cap8, U, LANES)
    span = wp["chunks"] * wp["rows_per_item"]
    ok_rows = torch.nn.functional.pad(ivf._cells8[slots[:n_unique].long()] >= 0,
                                      (0, span - cap8))
    busy_items = int(ok_rows.reshape(n_unique, wp["chunks"], -1).any(-1).sum())
    log(json.dumps({"wave_probe_plan": {"slots": slots.numel(),
                                        "unique_cells": n_unique,
                                        "rows_read": rows_read,
                                        "row_lane_pairs": pairs,
                                        "kernel_plan": wp,
                                        "busy_items": busy_items,
                                        "busy_blocks": busy_items * wp["splits"],
                                        "grid_blocks": wp["blocks_per_split"]
                                        * wp["splits"],
                                        "sms": torch.cuda.get_device_properties(
                                            dev).multi_processor_count}}))
    lw_b = torch.zeros(LANES, U, device=dev)
    p_b = torch.softmax(lw_b, 1)
    ps_b = waves["ivf"].p_hat.clone()
    sel_b = torch.as_tensor(waves["ivf"].selected[:, -1], device=dev)
    noise_b = torch.full((LANES,), 1e-3, device=dev)
    aug_b = torch.randint(0, 2 * m, (LANES, tail_cap), generator=rows_gen,
                          device=dev)
    # each lane's tail: as many active slots as the IVF wave's mean tail
    n_act_w = min(tail_cap, max(1, round(float(waves["ivf"].n_scored.mean()) - k)))
    active_b = (torch.arange(tail_cap, device=dev) < n_act_w).expand(
        LANES, tail_cap).contiguous()
    n_act_b = LANES * n_act_w
    # a quarter of each lane's tail active: rows past the 50 MB L2 (timing only)
    active_q = (torch.arange(tail_cap, device=dev) < tail_cap // 4).expand(
        LANES, tail_cap).contiguous()
    n_act_q = LANES * (tail_cap // 4)
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
        ("mwem_step_batch", "mwem_step_batch", "cluster:%d" % plan(U, LANES)[1],
         launches["mwem_step_batch"] - launches["mwem_step_batch:multiblock"],
         lambda: mwem_step_batch(lw_b, p_b, ps_b, Q, sel_b, hb_main, noise_b,
                                 rule="hardt", eta=eta),
         lambda: mwem_step_batch_ref(lw_b, p_b, ps_b, Q, sel_b, hb_main,
                                     noise_b, rule="hardt", eta=eta),
         None, LANES * (4.0 * 8 * U + 12), LANES * 12.0 * U),
        ("gather_score_batch", "gather_score_batch", score_route(score_plan(U)),
         launches["gather_score_batch"],
         lambda: gather_score_batch(Q, Vb, aug_b, active_b),
         lambda: gather_score_batch_ref(Q, Vb, aug_b, active_b),
         f32_tol(U, float((Q.abs() @ Vb.abs().T).max())),
         4.0 * n_act_b * U + 4 * LANES * U + 13 * LANES * tail_cap,
         2.0 * n_act_b * U),
        ("gather_score_batch:dense", "gather_score_batch", score_route(score_plan(U)),
         0, lambda: gather_score_batch(Q, Vb, aug_b, active_q),
         lambda: gather_score_batch_ref(Q, Vb, aug_b, active_q),
         f32_tol(U, float((Q.abs() @ Vb.abs().T).max())),
         4.0 * n_act_q * U + 4 * LANES * U + 13 * LANES * tail_cap,
         2.0 * n_act_q * U),
    ]
    # K6 and K2's cluster route at the factored path's shapes: the probe of
    # the marginal-IVF release, a tail of tail_cap slots with as many
    # active as that run's mean tail, the winner row as a (1, U) table. K6
    # needs the points of v its active candidates' cells cover (the union,
    # each once), an active slot's id, its query's clique and offset and
    # the clique's (stride, card, cell stride) a column, every slot's flag
    # and score, and one add a point of each cell.
    vf = h_m - fruns["mivf"].p_hat
    k_f = math.ceil(math.sqrt(Wm.m))
    cap_f = 4 * math.ceil(math.sqrt(2 * Wm.m))
    n_act_f = max(1, round(float(np.mean(fruns["mivf"].n_scored)) - k_f))
    aug_f = torch.randint(0, 2 * Wm.m, (cap_f,), generator=rows_gen, device=dev)
    act_f = torch.zeros(cap_f, dtype=torch.bool, device=dev)
    act_f[torch.randperm(cap_f, generator=rows_gen, device=dev)[:n_act_f]] = True
    mag_f = float(marginal_gather_score_ref(Wm, vf.abs(), aug_f % Wm.m).max())
    sel_f = torch.tensor(fruns["mivf"].selected[-1], device=dev)
    row_f, id_f = Wm.winner_table(sel_f)
    lw_f, p_f = torch.zeros(Wm.U, device=dev), torch.full((Wm.U,), 1.0 / Wm.U,
                                                          device=dev)
    ps_f = fruns["mivf"].p_hat.clone()
    eta_f = math.sqrt(math.log(Wm.U) / T)
    rows_fb = Wm.rows(torch.as_tensor(fruns["mivf"].selected[-LANES:],
                                      device=dev))
    sel_fb = torch.arange(LANES, device=dev)
    lw_fb = torch.zeros(LANES, Wm.U, device=dev)
    p_fb = torch.softmax(lw_fb, 1)
    ps_fb = ps_f.expand(LANES, -1).contiguous()
    noise_fb = torch.full((LANES,), 1e-3, device=dev)
    n_fast = sum(fcounts[kind]["marginal_gather_score"] for kind in ("flat", "mivf"))
    cells_f = Wm.rows(aug_f[act_f] % Wm.m)  # (n_act_f, U) indicators
    v_points_f = int(cells_f.amax(0).sum())
    adds_f = float(cells_f.sum())
    del cells_f
    # K2's three launches past the cluster's reach: one lane at U = 2**18
    u3 = 2 ** 18
    q3 = (torch.rand(2, u3, generator=rows_gen, device=dev) < 0.3).float()
    lw3 = torch.zeros(u3, device=dev)
    p3 = torch.full((u3,), 1.0 / u3, device=dev)
    ps3 = torch.rand(u3, generator=rows_gen, device=dev)
    h3 = torch.softmax(torch.randn(u3, generator=rows_gen, device=dev), 0)
    id3 = torch.tensor(1, device=dev)
    cases += [
        ("marginal_gather_score", "marginal_gather_score", None, n_fast,
         lambda: marginal_gather_score(Wm, vf, aug_f, act_f),
         lambda: marginal_gather_score_ref(Wm, vf, aug_f, act_f),
         f32_tol(Wm.U, mag_f),
         4.0 * v_points_f + 8 * n_act_f + cap_f + 4 * cap_f
         + 4 * 3 * Wm.kmax * n_act_f + 8 * n_act_f, adds_f),
        ("mwem_step:cluster", "mwem_step:cluster", "cluster:%d" % plan(Wm.U, 1)[1],
         launches["mwem_step:cluster"],
         lambda: mwem_step(lw_f, p_f, ps_f, row_f, id_f, h_m, noise,
                           rule="hardt", eta=eta_f),
         lambda: mwem_step_ref(lw_f, p_f, ps_f, row_f, id_f, h_m, noise,
                               rule="hardt", eta=eta_f),
         None, 4.0 * 8 * Wm.U + 16, 12.0 * Wm.U),
        ("mwem_step_batch:cluster", "mwem_step_batch:cluster",
         "cluster:%d" % plan(Wm.U, LANES)[1], launches["mwem_step_batch:cluster"],
         lambda: mwem_step_batch(lw_fb, p_fb, ps_fb, rows_fb, sel_fb, h_m,
                                 noise_fb, rule="hardt", eta=eta_f),
         lambda: mwem_step_batch_ref(lw_fb, p_fb, ps_fb, rows_fb, sel_fb, h_m,
                                     noise_fb, rule="hardt", eta=eta_f),
         None, LANES * (4.0 * 7 * Wm.U + 12) + 4.0 * Wm.U, LANES * 12.0 * Wm.U),
        ("mwem_step:multiblock", "mwem_step:multiblock", plan(u3, 1)[0],
         launches["mwem_step:multiblock"] - launches["mwem_step:cluster"],
         lambda: mwem_step(lw3, p3, ps3, q3, id3, h3, noise, rule="hardt",
                           eta=eta_f),
         lambda: mwem_step_ref(lw3, p3, ps3, q3, id3, h3, noise, rule="hardt",
                               eta=eta_f),
         None, 4.0 * 8 * u3 + 16, 12.0 * u3),
    ]
    # One PyTorch composition that computes K1's function, timed beside it
    # as its yardstick (the port never calls it). K5 has none: it is a
    # gather, a product, a mask and a top-k a lane.
    library = {
        "mips_topk": (lambda: torch.topk(torch.cat([s := torch.mv(Q, v), -s]), k),
                      "torch.topk(torch.cat([s, -s]), k) over s = torch.mv(Q, v)"),
        "mips_topk:plain": (lambda: torch.topk(torch.mv(cents, v), ivf.nprobe),
                            "torch.topk(torch.mv(V, q), k): two calls"),
    }
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
        elif "gather_score" in name:
            err = float((got - want).abs().max())
            ok = err <= tol
        else:
            err = max(float((a - b).abs().max()) for a, b in zip(got, want))
            ok = all(torch.allclose(a, b, rtol=1e-4, atol=1e-7)
                     for a, b in zip(got, want))
        expect(ok, f"{row} at main-path shapes: max err {err} (tol {tol})")
        ms, plain_ms = time_ms(kern), time_ms(plain)
        lib = library.get(row)
        lib_ms = time_ms(lib[0]) if lib else None
        b_ms, b_by = bound_ms(nbytes, flops)
        out = {"name": row, "route": "cuda", "source": SOURCES[name],
               "replaces": REPLACES[name], "launches": n_launch,
               "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}
        if lib:
            out["library"] = lib[1]
        out["replayed_ms"] = {"kernel": replayed_ms(kern),
                              "plain": replayed_ms(plain),
                              "library": replayed_ms(lib[0]) if lib else None}
        if name in ("gather_score", "gather_score_batch"):
            check_score_stages(row, kern, mode, expect)
        if name.startswith("mwem_step"):  # the kernels one call launches
            stages = stage_ms(kern)
            log(json.dumps({"stages_ms": row, **stages}))
            want_k = ({"mwem_step_cluster_kernel"} if mode.startswith("cluster")
                      else {"mwem_step_dots_kernel", "mwem_step_update_kernel",
                            "mwem_step_norm_kernel"})
            expect(set(stages) == want_k,
                   f"{row}: one call launched {sorted(stages)}, not {sorted(want_k)}")
        if mode:
            out["mode"] = mode
        if row in TIMING_ONLY:
            log(json.dumps({"timing_only": out}))
        else:
            rows_out.append(out)
        if row in ("mips_topk", "ivf_probe_batch", "marginal_gather_score"):
            log(json.dumps({"stages_ms": row, **stage_ms(kern)}))
        tag = f" [{out['mode']}]" if "mode" in out else ""
        log(f"{row}{tag}: {ms:.4f} ms (plain {plain_ms:.4f} ms, library "
            f"{'none' if lib_ms is None else f'{lib_ms:.4f} ms'}, bound "
            f"{b_ms:.4f} ms by {b_by}), max err {err:.3g}, launches {n_launch}"
            f"{'; back to back ' + json.dumps(out['replayed_ms']) if 'replayed_ms' in out else ''}")

    rows_out += lp_phases(args, dev, g, expect, ops)
    rows_out += lm_phases(args, dev, expect, ops)

    log(f"total: {time.perf_counter() - t_start:.1f} s")
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
