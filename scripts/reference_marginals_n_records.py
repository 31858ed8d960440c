#!/usr/bin/env python3
"""Release error of the JAX reference against the uniform histogram on
`chip_smoke.py`'s factored main path: all 4-way marginals over 15 binary
attributes (U = 2**15, m = 21840 cells), for two dataset sizes.

    PYTHONPATH=src python scripts/reference_marginals_n_records.py [--seed 0] [--T 1000]

The histogram follows the law of `chip_smoke.py`'s (from another numpy
stream, so not the same numbers): multinomial counts of n records under
``softmax(2·N(0,1))`` logits, divided by n, from numpy with ``--seed``. Runs `repro.run_mwem` at (ε, δ) = (1, 1e-3), rule hardt, in
fast mode over `MarginalIVFIndex` (T iterations) and in exact mode (T/10
iterations: the exhaustive oracle scores all 21840 implicit rows an
iteration), for n = 10000 and n = 100000, and prints one JSON line per run.
With the sensitivity 1/n, n sets how sharp the EM scores are and how loud
the Laplace measurements: the runs show whether a release at a given n
beats the uniform baseline on this workload, on the reference alone. It
imports only the JAX package and runs on the CPU (the four runs took
about 15 minutes on an 8-core CPU host).
"""

from __future__ import annotations

import argparse
import json

import jax
import jax.numpy as jnp
import numpy as np

from repro.core.mwem import MWEMConfig, run_mwem
from repro.core.queries import max_error
from repro.core.workload import MarginalWorkload
from repro.mips import MarginalIVFIndex


def histogram(seed: int, n: int, U: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    logits = 2.0 * rng.standard_normal(U)
    p = np.exp(logits - logits.max())
    return (rng.multinomial(n, p / p.sum()) / n).astype(np.float32)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--T", type=int, default=1000)
    args = ap.parse_args()
    W = MarginalWorkload.all_kway((2,) * 15, 4)
    index = MarginalIVFIndex(W)
    for n in (100_000, 10_000):
        h = jnp.asarray(histogram(args.seed, n, W.U))
        uniform = float(max_error(W, h, jnp.full((W.U,), 1.0 / W.U)))
        for mode, T in (("fast", args.T), ("exact", max(1, args.T // 10))):
            cfg = MWEMConfig(eps=1.0, delta=1e-3, T=T, mode=mode, n_records=n,
                             use_pallas="never")
            res = run_mwem(W, h, cfg, jax.random.PRNGKey(args.seed + 1),
                           index=index if mode == "fast" else None)
            print(json.dumps({"U": W.U, "m": W.m, "T": T, "n_records": n,
                              "mode": mode,
                              "final_error": float(res.final_error),
                              "uniform_error": uniform}), flush=True)


if __name__ == "__main__":
    main()
