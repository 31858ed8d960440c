"""K8's plain version and the port's attention layer held to `repro`.

The plain version (`repro_torch.kernels.flash_attention.attention_ref`,
what the wrapper runs for CPU tensors) is compared with the reference's
Pallas kernel in interpret mode and with its jnp oracle on the same numpy
inputs: all four masks, GQA groups of 1, 3 and 4, ragged Sq and Skv,
decode rows at a ``q_offset``, a logit softcap, rows that see no key, and
bf16. Tolerances: f32 rtol/atol 2e-4 (the reference's own kernel tests,
`tests/test_kernels.py`: online softmax against one pass); bf16 2e-2 (an
output rounded to 8 mantissa bits). The CUDA kernel runs only on the card,
where `chip_smoke.py` holds it to this plain version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.kernels.flash_attention import attention_ref as jax_attention_ref
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.flash_attention.ref import make_mask as jax_make_mask
from repro.models import attention as ref_att
from repro.models.common import ParamBuilder

from repro_torch.configs import get_smoke_config
from repro_torch.kernels.flash_attention import (attention_ref, flash_attention,
                                                 make_mask)
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models import attention as att

F32_TOL = dict(rtol=2e-4, atol=2e-4)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)


def _qkv(seed, B, Hq, Hkv, Sq, Skv, D, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Hq, Sq, D)).astype(dtype),
            rng.standard_normal((B, Hkv, Skv, D)).astype(dtype),
            rng.standard_normal((B, Hkv, Skv, D)).astype(dtype))


def _both(q, k, v, **kw):
    """(port's plain K8, reference kernel in interpret mode, reference
    oracle) on the same inputs, as f32 numpy."""
    mine = flash_attention(*map(torch.as_tensor, (q, k, v)), **kw)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    kern = jax_flash(jq, jk, jv, block_q=16, block_kv=16, interpret=True, **kw)
    oracle = jax_attention_ref(jq, jk, jv, **kw)
    return (mine.numpy(), np.asarray(kern, np.float32),
            np.asarray(oracle, np.float32))


class TestPlainKernel:
    @pytest.mark.parametrize("mode,window", [
        ("full", 0), ("causal", 0), ("window", 7), ("window", 24),
        ("chunk", 16), ("chunk", 5)])
    @pytest.mark.parametrize("g", [1, 3, 4])
    def test_masks_and_groups(self, mode, window, g):
        q, k, v = _qkv(g, 2, 2 * g, 2, 37, 37, 16)
        mine, kern, oracle = _both(q, k, v, mode=mode, window=window)
        np.testing.assert_allclose(mine, kern, **F32_TOL)
        np.testing.assert_allclose(mine, oracle, **F32_TOL)

    @pytest.mark.parametrize("sq,skv,q_offset", [
        (1, 50, 49), (1, 64, 20), (5, 53, 48), (19, 41, 0), (33, 17, 0)])
    @pytest.mark.parametrize("mode,window", [("causal", 0), ("window", 9),
                                             ("chunk", 8)])
    def test_ragged_and_offset(self, sq, skv, q_offset, mode, window):
        """Decode (Sq = 1 at the cache position), prefill continuation,
        and Sq, Skv no tile multiple; q_offset past Skv's end included."""
        q, k, v = _qkv(sq + skv, 1, 3, 1, sq, skv, 12)
        mine, kern, oracle = _both(q, k, v, mode=mode, window=window,
                                   q_offset=q_offset)
        np.testing.assert_allclose(mine, kern, **F32_TOL)
        np.testing.assert_allclose(mine, oracle, **F32_TOL)

    def test_rows_that_see_no_key_are_zero(self):
        # chunk 16, positions 40..43 lie in chunk [32, 48); keys end at 30
        q, k, v = _qkv(3, 1, 2, 1, 4, 30, 8)
        mine, kern, oracle = _both(q, k, v, mode="chunk", window=16,
                                   q_offset=40)
        assert np.all(mine == 0.0)
        np.testing.assert_array_equal(mine, oracle)
        np.testing.assert_allclose(mine, kern, **F32_TOL)

    @pytest.mark.parametrize("cap", [5.0, 20.0])
    def test_softcap(self, cap):
        q, k, v = _qkv(4, 1, 4, 2, 32, 40, 8)
        q = q * 4.0  # logits large enough for the cap to bite
        mine, kern, oracle = _both(q, k, v, mode="causal", logit_softcap=cap)
        np.testing.assert_allclose(mine, kern, **F32_TOL)
        np.testing.assert_allclose(mine, oracle, **F32_TOL)

    @pytest.mark.parametrize("mode,q_offset,sq", [("causal", 0, 64),
                                                  ("causal", 63, 1),
                                                  ("full", 0, 20)])
    def test_bf16(self, mode, q_offset, sq):
        q, k, v = _qkv(5, 1, 4, 1, sq, 64, 16)
        qt, kt, vt = (torch.as_tensor(x).to(torch.bfloat16) for x in (q, k, v))
        mine = flash_attention(qt, kt, vt, mode=mode, q_offset=q_offset)
        assert mine.dtype == torch.bfloat16
        jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
        kern = jax_flash(jq, jk, jv, mode=mode, q_offset=q_offset, block_q=16,
                         block_kv=16, interpret=True)
        oracle = jax_attention_ref(jq, jk, jv, mode=mode, q_offset=q_offset)
        np.testing.assert_allclose(mine.float().numpy(),
                                   np.asarray(kern, np.float32), **BF16_TOL)
        np.testing.assert_allclose(mine.float().numpy(),
                                   np.asarray(oracle, np.float32), **BF16_TOL)

    @pytest.mark.parametrize("mode,window", [("full", 0), ("causal", 0),
                                             ("window", 6), ("chunk", 4)])
    def test_mask_matches_reference(self, mode, window):
        mine = make_mask(9, 14, mode, window, q_offset=3)
        ref = jax_make_mask(9, 14, mode, window, 3)
        np.testing.assert_array_equal(mine.numpy(), np.asarray(ref))


class TestWrapper:
    def test_cpu_runs_plain_version_without_a_launch(self):
        q, k, v = map(torch.as_tensor, _qkv(6, 1, 4, 2, 10, 10, 8))
        before = flash_attention.launches
        got = flash_attention(q, k, v, mode="causal")
        assert torch.equal(got, attention_ref(q, k, v, mode="causal"))
        assert flash_attention.launches == before

    def test_bad_arguments_raise(self):
        q, k, v = map(torch.as_tensor, _qkv(7, 1, 4, 2, 10, 10, 8))
        with pytest.raises(ValueError, match="mask mode"):
            flash_attention(q, k, v, mode="sliding")
        with pytest.raises(ValueError, match="window > 0"):
            flash_attention(q, k, v, mode="window")
        with pytest.raises(ValueError, match="q_offset"):
            flash_attention(q, k, v, q_offset=-1)
        with pytest.raises(ValueError, match="GQA"):
            flash_attention(q[:, :3], k, v)

    @pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,D,want", [
        (4, 24, 8, 2048, 2048, 128, (64, 128, 1)),   # llama3.2-3b prefill
        (1, 24, 8, 1987, 1987, 128, (64, 128, 1)),   # a refill prefill
        (4, 24, 8, 1, 2112, 128, (16, 128, 8)),      # llama3.2-3b decode
        (1, 4, 2, 1, 30, 12, (16, 32, 1)),           # one kv tile: no split
        (2, 8, 1, 2, 500, 64, (16, 64, 8)),          # g·Sq = 16 rows
        (2, 8, 1, 3, 500, 64, (64, 64, 8)),          # g·Sq = 24 rows
    ])
    def test_launch_plan(self, B, Hq, Hkv, Sq, Skv, D, want):
        """The decode route takes 16-row tiles, and a grid under two blocks
        an SM splits the kv range (at most one split a 64-key tile)."""
        assert fa_ops.plan(B, Hq, Hkv, Sq, Skv, D) == want


# --------------------------------------------------- the attention layer

def _layer(seed=0):
    cfg = get_smoke_config("llama3.2-3b").with_(dtype="float32")
    ref_cfg = ref_smoke_config("llama3.2-3b").with_(dtype="float32")
    pb = ParamBuilder(jax.random.PRNGKey(seed), dtype=jnp.float32)
    ref_att.init_attention(pb, ref_cfg, "attn")
    ref_p = pb.params["attn"]
    mine_p = {k: torch.as_tensor(np.asarray(v)) for k, v in ref_p.items()}
    return cfg, ref_cfg, ref_p, mine_p


class TestAttentionLayer:
    @pytest.mark.parametrize("S", [1, 9, 40])
    def test_forward_matches_reference(self, S):
        cfg, ref_cfg, ref_p, mine_p = _layer(S)
        rng = np.random.default_rng(S)
        x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
        pos = np.broadcast_to(np.arange(S)[None], (2, S))
        y_r, (k_r, v_r) = ref_att.attn_forward(ref_p, jnp.asarray(x), ref_cfg,
                                               "attn", jnp.asarray(pos),
                                               return_kv=True)
        y_m, (k_m, v_m) = att.attn_forward(mine_p, torch.as_tensor(x), cfg,
                                           "attn", torch.as_tensor(pos),
                                           return_kv=True)
        np.testing.assert_allclose(y_m.numpy(), np.asarray(y_r), rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(k_m.numpy(), np.asarray(k_r), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(v_m.numpy(), np.asarray(v_r), rtol=1e-5,
                                   atol=1e-6)

    @pytest.mark.parametrize("pos", [0, 7, 23])
    def test_decode_matches_reference(self, pos):
        cfg, ref_cfg, ref_p, mine_p = _layer(pos + 1)
        rng = np.random.default_rng(pos)
        max_len = 24
        shape = (3, cfg.n_kv_heads, max_len, cfg.resolved_head_dim)
        k0 = rng.standard_normal(shape).astype(np.float32)
        v0 = rng.standard_normal(shape).astype(np.float32)
        x = rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
        y_r, c_r = ref_att.attn_decode(ref_p, jnp.asarray(x),
                                       {"k": jnp.asarray(k0), "v": jnp.asarray(v0)},
                                       jnp.int32(pos), ref_cfg, "attn")
        cache = {"k": torch.as_tensor(k0.copy()), "v": torch.as_tensor(v0.copy())}
        y_m, c_m = att.attn_decode(mine_p, torch.as_tensor(x), cache, pos, cfg,
                                   "attn")
        assert c_m is cache  # written in place
        np.testing.assert_allclose(y_m.numpy(), np.asarray(y_r), rtol=1e-4,
                                   atol=1e-5)
        for name in ("k", "v"):
            np.testing.assert_allclose(c_m[name].numpy(), np.asarray(c_r[name]),
                                       rtol=1e-5, atol=1e-6)

    def test_init_cache_shape(self):
        cfg = get_smoke_config("llama3.2-3b")
        c = att.init_attn_cache(cfg, "attn", 3, 17, torch.bfloat16, "cpu")
        assert c["k"].shape == (3, cfg.n_kv_heads, 17, cfg.resolved_head_dim)
        assert c["v"].dtype == torch.bfloat16 and not c["v"].any()

    @pytest.mark.parametrize("kind", ["window_attn", "chunk_attn", "attn_bidir",
                                      "xattn_dec"])
    def test_later_kinds_raise(self, kind):
        cfg, _, _, mine_p = _layer()
        x = torch.zeros((1, 3, cfg.d_model))
        pos = torch.zeros((1, 3), dtype=torch.int64)
        with pytest.raises(NotImplementedError, match="later slice"):
            att.attn_forward(mine_p, x, cfg, kind, pos)
