#!/usr/bin/env python3
"""Device time of one mamba2-130m prefill call of the PyTorch/CUDA port on
the card, for the port found under --src (a checkout's ``src/``).

    python3 scripts/time_mamba_prefill.py [--src src] [--batch 4] [--len 580]
                                          [--reps 10] [--seed 0]

Imports ``repro_torch`` from --src (never the JAX package), so two trees —
say a parent commit unpacked with ``git archive`` and this one — can be
compared on one card within one call, in turns (parent, change, change,
parent). It builds that tree's kernels, draws mamba2-130m's weights at its
published widths from --seed, and prefills a (batch, len) wave of random
tokens (the shape of `chip_smoke.py`'s ``ssd_scan`` row: the first wave of
its mamba serving run). It prints one JSON line: the card, the median
CUDA-event ms of a prefill call over --reps calls after two warm-up calls,
and, from one `torch.profiler` trace of one call, the device busy ms and
the ms of the SSD scan's kernels (K9) in it. It needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1] / "src"))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--len", type=int, default=580)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    src = Path(args.src).resolve()
    sys.path.insert(0, str(src))

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("time_mamba_prefill: no CUDA device is available", file=sys.stderr)
        return 2
    import repro_torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.models import build_model

    assert Path(repro_torch.__file__).resolve().is_relative_to(src)
    _build.build_all()
    dev = torch.device("cuda")
    cfg = get_config("mamba2-130m")
    model = build_model(cfg).init(args.seed, device=dev)
    rng = np.random.default_rng([args.seed, 25])
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (args.batch, args.len)),
                             device=dev)
    batch = {"tokens": tokens}

    def call():
        return model.prefill(batch, max_len=args.len + 64)

    for _ in range(2):
        call()
    torch.cuda.synchronize()
    times = []
    for _ in range(args.reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        call()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    busy = k9 = 0.0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us = e.time_range.elapsed_us()
            busy += us
            if "ssd_" in e.name:
                k9 += us
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps({"src": str(src), "card": card, "shape": [args.batch, args.len],
                      "prefill_ms_median": float(np.median(times)),
                      "prefill_ms_all": times, "device_busy_ms": busy / 1e3,
                      "ssd_scan_ms": k9 / 1e3,
                      "ssd_scan_share_of_busy": k9 / busy if busy else None}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
