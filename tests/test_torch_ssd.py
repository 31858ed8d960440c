"""K9's plain version and the port's Mamba-2 block held to `repro`.

The plain version (`repro_torch.kernels.ssd_scan.ssd_chunked`, what the
wrapper runs for CPU tensors) returns the output y and the final state;
it is compared with the reference's Pallas kernel in interpret mode (y:
the TPU kernel keeps its state in scratch and returns y only), with the
sequential recurrence `ssd_scan_ref` and with the chunked
`ssd_chunked_jnp` (y and the final state), at sequence lengths that are
no chunk multiple, chunks of 8, 16 and 64, and several H, P and N.
Tolerance rtol/atol 2e-4, the reference's own kernel tests'
(`tests/test_kernels.py`): chunked against sequential sums in f32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.kernels.ssd_scan import ssd_chunked_jnp
from repro.kernels.ssd_scan import ssd_scan as jax_ssd_scan
from repro.kernels.ssd_scan import ssd_scan_ref as jax_ssd_ref
from repro.models import ssm as ref_ssm
from repro.models.common import ParamBuilder
from repro.models.lm import LM as RefLM

from repro_torch.configs import get_smoke_config
from repro_torch.kernels.ssd_scan import ssd_chunked, ssd_scan, ssd_scan_ref
from repro_torch.models import ssm

TOL = dict(rtol=2e-4, atol=2e-4)


def _inputs(seed, b, s, h, p, n):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, h, p)).astype(np.float32),
            rng.uniform(0.01, 0.5, (b, s, h)).astype(np.float32),
            (-rng.uniform(0.1, 2.0, (h,))).astype(np.float32),
            rng.standard_normal((b, s, n)).astype(np.float32),
            rng.standard_normal((b, s, n)).astype(np.float32))


class TestPlainKernel:
    @pytest.mark.parametrize("s,chunk", [(37, 8), (64, 16), (45, 16),
                                         (100, 64), (7, 8), (130, 64)])
    @pytest.mark.parametrize("h,p,n", [(1, 4, 4), (3, 8, 12), (2, 16, 6)])
    def test_matches_reference(self, s, chunk, h, p, n):
        args = _inputs(s * 7 + h, 2, s, h, p, n)
        y, hT = ssd_scan(*map(torch.as_tensor, args), chunk=chunk)
        jargs = tuple(map(jnp.asarray, args))
        y_kern = jax_ssd_scan(*jargs, chunk=chunk, interpret=True)
        y_seq, hT_seq = jax_ssd_ref(*jargs)
        y_chk, hT_chk = ssd_chunked_jnp(*jargs, chunk=min(chunk, max(8, s)))
        np.testing.assert_allclose(y.numpy(), np.asarray(y_kern), **TOL)
        np.testing.assert_allclose(y.numpy(), np.asarray(y_seq), **TOL)
        np.testing.assert_allclose(y.numpy(), np.asarray(y_chk), **TOL)
        np.testing.assert_allclose(hT.numpy(), np.asarray(hT_seq), **TOL)
        np.testing.assert_allclose(hT.numpy(), np.asarray(hT_chk), **TOL)

    @pytest.mark.parametrize("s", [3, 17, 50])
    def test_sequential_matches_reference(self, s):
        args = _inputs(s, 2, s, 2, 5, 3)
        y, hT = ssd_scan_ref(*map(torch.as_tensor, args))
        y_r, hT_r = jax_ssd_ref(*map(jnp.asarray, args))
        np.testing.assert_allclose(y.numpy(), np.asarray(y_r), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(hT.numpy(), np.asarray(hT_r), rtol=1e-5,
                                   atol=1e-5)

    def test_padding_leaves_the_final_state(self):
        """S = 45 in chunks of 16 pads three steps with dt = 0: the final
        state is the sequential one at step 45, not a later one."""
        args = [torch.as_tensor(a) for a in _inputs(11, 1, 45, 2, 4, 4)]
        _, hT = ssd_chunked(*args, chunk=16)
        _, hT_seq = ssd_scan_ref(*args)
        np.testing.assert_allclose(hT.numpy(), hT_seq.numpy(), **TOL)

    def test_initial_state_continues(self):
        args = [torch.as_tensor(a) for a in _inputs(12, 1, 48, 2, 4, 4)]
        y_all, h_all = ssd_chunked(*args, chunk=8)
        first = [a[:, :20] if a.dim() > 1 else a for a in args]
        rest = [a[:, 20:] if a.dim() > 1 else a for a in args]
        _, h20 = ssd_chunked(*first, chunk=8)
        y2, h2 = ssd_chunked(*rest, chunk=8, h0=h20)
        jargs = [jnp.asarray(a.numpy()) for a in rest]
        y2_r, h2_r = ssd_chunked_jnp(*jargs, chunk=8, h0=jnp.asarray(h20.numpy()))
        np.testing.assert_allclose(y2.numpy(), y_all[:, 20:].numpy(), **TOL)
        np.testing.assert_allclose(h2.numpy(), h_all.numpy(), **TOL)
        np.testing.assert_allclose(y2.numpy(), np.asarray(y2_r), **TOL)
        np.testing.assert_allclose(h2.numpy(), np.asarray(h2_r), **TOL)


class TestWrapper:
    def test_cpu_runs_plain_version_without_a_launch(self):
        args = [torch.as_tensor(a) for a in _inputs(1, 1, 20, 2, 4, 4)]
        before = ssd_scan.launches
        y, hT = ssd_scan(*args, chunk=64)
        y_p, hT_p = ssd_chunked(*args, chunk=20)  # min(64, max(8, S))
        assert torch.equal(y, y_p) and torch.equal(hT, hT_p)
        assert ssd_scan.launches == before

    def test_bad_shapes_raise(self):
        x, dt, A, Bm, Cm = (torch.as_tensor(a) for a in _inputs(2, 1, 9, 2, 4, 4))
        with pytest.raises(ValueError, match="ssd_scan shapes"):
            ssd_scan(x, dt[:, :, :1], A, Bm, Cm)
        with pytest.raises(ValueError, match="ssd_scan shapes"):
            ssd_scan(x, dt, A, Bm, Cm[:, :, :3])


# ------------------------------------------------------ the Mamba-2 block

def _block(seed=0):
    cfg = get_smoke_config("mamba2-130m").with_(dtype="float32")
    ref_cfg = ref_smoke_config("mamba2-130m").with_(dtype="float32")
    pb = ParamBuilder(jax.random.PRNGKey(seed), dtype=jnp.float32)
    ref_ssm.init_ssm(pb, ref_cfg, "ssm")
    ref_p = dict(pb.params["ssm"])
    rng = np.random.default_rng(seed)  # non-trivial dt bias, A, skip, norm
    for name in ("dt_bias", "A_log", "D_skip", "norm_scale", "conv_b"):
        ref_p[name] = jnp.asarray(0.3 * rng.standard_normal(ref_p[name].shape),
                                  jnp.float32)
    mine_p = {k: torch.as_tensor(np.array(v)) for k, v in ref_p.items()}
    return cfg, ref_cfg, ref_p, mine_p


class TestSSMBlock:
    @pytest.mark.parametrize("S", [2, 13, 24])
    def test_forward_and_prefill_match_reference(self, S):
        cfg, ref_cfg, ref_p, mine_p = _block(S)
        x = np.random.default_rng(S).standard_normal(
            (2, S, cfg.d_model)).astype(np.float32)
        y_r = ref_ssm.ssm_forward(ref_p, jnp.asarray(x), ref_cfg)
        y_m = ssm.ssm_forward(mine_p, torch.as_tensor(x), cfg)
        np.testing.assert_allclose(y_m.numpy(), np.asarray(y_r), **TOL)
        out_r, c_r = RefLM(ref_cfg)._ssm_prefill(ref_p, jnp.asarray(x))
        out_m, c_m = ssm.ssm_prefill(mine_p, torch.as_tensor(x), cfg)
        np.testing.assert_allclose(out_m.numpy(), np.asarray(out_r), **TOL)
        for name in ("conv", "state"):
            np.testing.assert_allclose(c_m[name].numpy(), np.asarray(c_r[name]),
                                       **TOL)

    def test_decode_continues_prefill(self):
        """Decode steps from the prefill cache match the reference's, and
        the whole sequence's forward at the decoded positions."""
        cfg, ref_cfg, ref_p, mine_p = _block(5)
        x = np.random.default_rng(5).standard_normal(
            (2, 12, cfg.d_model)).astype(np.float32)
        _, c_r = RefLM(ref_cfg)._ssm_prefill(ref_p, jnp.asarray(x[:, :9]))
        _, c_m = ssm.ssm_prefill(mine_p, torch.as_tensor(x[:, :9]), cfg)
        full = ssm.ssm_forward(mine_p, torch.as_tensor(x), cfg)
        for t in range(9, 12):
            y_r, c_r = ref_ssm.ssm_decode(ref_p, jnp.asarray(x[:, t:t + 1]), c_r,
                                          ref_cfg)
            y_m, c_m = ssm.ssm_decode(mine_p, torch.as_tensor(x[:, t:t + 1]), c_m,
                                      cfg)
            np.testing.assert_allclose(y_m.numpy(), np.asarray(y_r), **TOL)
            np.testing.assert_allclose(y_m.numpy(), full[:, t:t + 1].numpy(),
                                       **TOL)
            for name in ("conv", "state"):
                np.testing.assert_allclose(c_m[name].numpy(),
                                           np.asarray(c_r[name]), **TOL)

    def test_causal_conv_is_shifted_products(self):
        rng = np.random.default_rng(3)
        x = rng.standard_normal((2, 7, 5)).astype(np.float32)
        w = rng.standard_normal((4, 5)).astype(np.float32)
        b = rng.standard_normal(5).astype(np.float32)
        got = ssm._causal_conv(*map(torch.as_tensor, (x, w, b)))
        want = ref_ssm._causal_conv(*map(jnp.asarray, (x, w, b)))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)

    def test_init_cache_shapes(self):
        cfg = get_smoke_config("mamba2-130m")
        c = ssm.init_ssm_cache(cfg, 3, "cpu")
        d_inner, H, N, P = ssm._dims(cfg)
        assert c["conv"].shape == (3, cfg.ssm_conv - 1, d_inner + 2 * N)
        assert c["state"].shape == (3, H, P, N)
