"""K7, the fused multiplicative-weights update, and the dense Bregman
projection, held to `repro` on the same inputs.

The plain version of K7 (`mwu_update_ref`, what the CPU runs and what
`chip_smoke.py` holds the CUDA kernel to on the card) is compared with the
reference's Pallas program in interpret mode and with its jnp oracle.
Tolerances: ``lw'`` equal bit for bit to the oracle's ``lw + coef·c`` (one
rounded product and one rounded sum either way) and within 1e-6 of the
Pallas program's; ``p`` at rtol 1e-5, atol 1e-8 (a sum of up to 4096
exponentials in another order). The projection agrees to rtol 1e-5, atol
1e-8.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.bregman import bregman_project_dense as ref_bregman
from repro.kernels.mwu_update.ops import mwu_update as ref_mwu_update
from repro.kernels.mwu_update.ref import mwu_update_ref as ref_mwu_oracle

from repro_torch.core.bregman import bregman_project_dense
from repro_torch.kernels.mwu_update import mwu_update, mwu_update_ref

COEFS = [-0.37, 0.0, 1.5]


def _row(rng, U, scale=3.0):
    return (scale * rng.standard_normal(U)).astype(np.float32)


@pytest.mark.parametrize("coef", COEFS)
@pytest.mark.parametrize("U", [1, 7, 20, 21, 300, 1025, 4096])
def test_plain_matches_reference(U, coef):
    rng = np.random.default_rng([U, 11])
    lw, c = _row(rng, U), _row(rng, U, 1.0)
    lw_o, p_o = ref_mwu_oracle(jnp.asarray(lw), jnp.asarray(c), coef)
    lw_k, p_k = ref_mwu_update(jnp.asarray(lw), jnp.asarray(c), coef,
                               interpret=True)
    out, p, m, s = mwu_update(torch.from_numpy(lw), torch.from_numpy(c), coef)
    np.testing.assert_array_equal(out.numpy(), np.asarray(lw_o))
    np.testing.assert_allclose(out.numpy(), np.asarray(lw_k), rtol=1e-6,
                               atol=1e-6)
    for ref_p in (p_o, p_k):
        np.testing.assert_allclose(p.numpy(), np.asarray(ref_p), rtol=1e-5,
                                   atol=1e-8)
    assert float(m) == float(np.max(np.asarray(lw_o)))
    np.testing.assert_allclose(float(s), float(np.exp(out.numpy() - float(m))
                                               .astype(np.float64).sum()),
                               rtol=1e-5)
    assert m.dim() == 0 and s.dim() == 0


@pytest.mark.parametrize("U", [1, 20, 1025])
def test_lane_grid_equals_rows(U):
    """(B, U) rows, dense and by row id, equal the single-row calls."""
    rng = np.random.default_rng([U, 12])
    B, n = 5, 9
    lw = torch.from_numpy(np.stack([_row(rng, U) for _ in range(B)]))
    table = torch.from_numpy(np.stack([_row(rng, U, 1.0) for _ in range(n)]))
    rows = torch.tensor([3, 0, 8, 3, 5])
    dense = table[rows]
    for coef in COEFS:
        by_id = mwu_update(lw, table, coef, rows=rows)
        by_row = mwu_update(lw, dense, coef)
        for a, b in zip(by_id, by_row):
            assert torch.equal(a, b)
        for b_ in range(B):
            one = mwu_update(lw[b_], dense[b_], coef)
            one_id = mwu_update(lw[b_], table, coef, rows=rows[b_])
            for got, a, c in zip(by_row, one, one_id):
                torch.testing.assert_close(got[b_], a, rtol=1e-6, atol=1e-9)
                assert torch.equal(a, c)


def test_plain_version_is_the_formula():
    lw = torch.tensor([[0.0, -1.0, 2.0], [5.0, 5.0, 5.0]])
    c = torch.tensor([[1.0, 1.0, -1.0], [0.0, 2.0, 0.0]])
    out, p, m, s = mwu_update_ref(lw, c, -0.5)
    assert torch.equal(out, lw - 0.5 * c)
    assert torch.equal(m, out.amax(1))
    torch.testing.assert_close(p, torch.softmax(out, 1))
    torch.testing.assert_close(s, torch.exp(out - m[:, None]).sum(1))


@pytest.mark.parametrize("m,s", [(1, 0.5), (1, 1.0), (13, 1.0), (13, 2.0),
                                 (13, 5.0), (64, 2.0), (64, 12.0),
                                 (300, 5.0), (300, 12.0)])
def test_bregman_matches_reference(m, s):
    rng = np.random.default_rng([m, int(4 * s)])
    a = np.exp(3.0 * rng.standard_normal(m)).astype(np.float32)
    a[rng.random(m) < 0.1] = 0.0       # zero mass is floored, as there
    y = bregman_project_dense(torch.from_numpy(a), s)
    want = np.asarray(ref_bregman(jnp.asarray(a), s))
    np.testing.assert_allclose(y.numpy(), want, rtol=1e-5, atol=1e-8)
    if s > 1:
        assert float(y.max()) <= 1.0 / s * (1 + 1e-5)
    assert float(y.sum()) == pytest.approx(1.0, abs=1e-6)


def test_bregman_caps_dense_tail():
    """A measure with one heavy entry: the projection clips it at 1/s and
    spreads the rest in proportion, as the reference does."""
    a = np.array([1000.0, 1.0, 2.0, 3.0, 4.0], np.float32)
    y = bregman_project_dense(torch.from_numpy(a), 2.0)
    np.testing.assert_allclose(y.numpy(), np.asarray(ref_bregman(
        jnp.asarray(a), 2.0)), rtol=1e-6)
    assert float(y[0]) == pytest.approx(0.5, rel=1e-6)
