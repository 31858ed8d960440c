#!/usr/bin/env python3
"""Release error of the JAX reference against the uniform histogram, at
CPU-sized analogues of `chip_smoke.py`'s main path, for two dataset sizes.

    PYTHONPATH=src python scripts/reference_n_records.py [--seed 0]

Runs `repro.run_mwem` (exact, and fast over the flat index) at
(ε, δ) = (1, 1e-3) on §5.1 binary queries and a Gaussian histogram, for
n = 500 and n = 100000 records, and prints one JSON line per run. Two
shapes: U = 2**12, m = 2**12, T = 300; and the main path's U = 2**14 and
T = 1000 with m cut from 2**16 to 2**12 base queries (m enters the
selection only through log m). With the sensitivity 1/n, n sets how sharp
the EM scores are and how loud the Laplace measurements: it shows whether
a release at a given n can beat the uniform baseline at all, on the
reference alone. It imports only the JAX package and runs on the CPU.
"""

from __future__ import annotations

import argparse
import json

import jax
import jax.numpy as jnp

from repro.core.mwem import MWEMConfig, run_mwem
from repro.core.queries import gaussian_histogram, max_error, random_binary_queries
from repro.mips import FlatAbsIndex

SHAPES = ((2 ** 12, 2 ** 12, 300), (2 ** 14, 2 ** 12, 1000))  # (U, m, T)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    k_q, k_h, k_run = jax.random.split(jax.random.PRNGKey(args.seed), 3)
    for U, m, T in SHAPES:
        Q = random_binary_queries(k_q, m, U)
        index = FlatAbsIndex(Q, use_pallas="never")
        for n in (500, 100_000):
            h = gaussian_histogram(k_h, n, U)
            uniform = float(max_error(Q, h, jnp.full((U,), 1.0 / U)))
            for mode in ("exact", "fast"):
                cfg = MWEMConfig(eps=1.0, delta=1e-3, T=T, mode=mode,
                                 n_records=n)
                res = run_mwem(Q, h, cfg, k_run,
                               index=index if mode == "fast" else None)
                print(json.dumps({"U": U, "m": m, "T": T, "n_records": n,
                                  "mode": mode,
                                  "final_error": float(res.final_error),
                                  "uniform_error": uniform}), flush=True)


if __name__ == "__main__":
    main()
