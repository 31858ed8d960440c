"""Serving launcher: batched decode over a smoke or published config, with
random weights from ``--seed``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-3b \
        --smoke --device cpu --requests 8 --new-tokens 16

It runs on ``cuda`` unless ``--device`` names another device, and raises
without a card. On the card the serving time comes from CUDA events; the
CPU gives no device time, so none is printed there.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without one)")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.device import resolve_device
    from repro_torch.models import build_model
    from repro_torch.serve.engine import Request, ServeEngine

    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = build_model(cfg).init(args.seed, device=dev)
    rng = np.random.default_rng(args.seed)
    requests = [
        Request(prompt=rng.integers(0, cfg.vocab_size, args.prompt_len).tolist(),
                max_new_tokens=args.new_tokens, temperature=args.temperature)
        for _ in range(args.requests)
    ]
    engine = ServeEngine(model, batch_size=args.batch_size,
                         max_len=args.prompt_len + args.new_tokens + 4,
                         seed=args.seed, device=dev)
    total_s = None
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        engine.run(requests)
        end.record()
        end.synchronize()
        total_s = start.elapsed_time(end) / 1e3
    else:
        engine.run(requests)
    total = sum(len(r.out_tokens) for r in requests)
    msg = f"served {len(requests)} requests, {total} tokens"
    if total_s is not None:
        msg += f" in {total_s:.2f}s ({total / total_s:.1f} tok/s) on {dev}"
    print(msg)
    for i, r in enumerate(requests[:4]):
        print(f"req{i}: {r.out_tokens[:12]} …")
    return requests


if __name__ == "__main__":
    main()
