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

    @pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                             ids=["bf16", "f32"])
    @pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,D,want_bf16,want_f32", [
        # llama3.2-3b prefill: 64-row blocks, no split
        (4, 24, 8, 2048, 2048, 128, ("mma", 64, 128, 1), ("f32", 64, 128, 1)),
        # a refill prefill
        (1, 24, 8, 1987, 1987, 128, ("mma", 64, 128, 1), ("f32", 64, 128, 1)),
        # llama3.2-3b decode: 33 tiles in 8 splits, 256 blocks
        (4, 24, 8, 1, 2112, 128, ("decode", 3, 128, 8), ("decode", 3, 128, 8)),
        # one kv tile: no split
        (1, 4, 2, 1, 30, 12, ("decode", 2, 32, 1), ("decode", 2, 32, 1)),
        # g·Sq = 16 rows: still decode, one tile a split
        (2, 8, 1, 2, 500, 64, ("decode", 16, 64, 8), ("decode", 16, 64, 8)),
        # g·Sq = 24 rows: prefill; only the f32 route splits a small grid
        (2, 8, 1, 3, 500, 64, ("mma", 64, 64, 1), ("f32", 64, 64, 8)),
        # g = 8 decode over a long cache: one tile a split
        (1, 8, 1, 1, 5000, 64, ("decode", 8, 64, 79), ("decode", 8, 64, 79)),
        # 16 rows of g = 16, D = 100 padded to 128
        (2, 16, 1, 1, 100, 100, ("decode", 16, 128, 2), ("decode", 16, 128, 2)),
        # 12 rows of Sq 6: decode rows round up to 16
        (1, 6, 3, 6, 64, 128, ("decode", 16, 128, 1), ("decode", 16, 128, 1)),
        # MHA decode: one row a block
        (3, 8, 8, 1, 300, 64, ("decode", 1, 64, 5), ("decode", 1, 64, 5)),
        # g·Sq = 5 rounds up to 8
        (1, 5, 1, 1, 64, 32, ("decode", 8, 32, 1), ("decode", 8, 32, 1)),
        # 68 rows, a grid of 16 blocks
        (1, 32, 8, 17, 17, 64, ("mma", 64, 64, 1), ("f32", 64, 64, 1)),
        # 18 rows, one block: the f32 route splits 5 tiles
        (1, 2, 1, 9, 300, 32, ("mma", 64, 32, 1), ("f32", 64, 32, 5)),
    ])
    def test_launch_plan(self, B, Hq, Hkv, Sq, Skv, D, want_bf16, want_f32, dtype):
        """bf16 prefill (g·Sq > 16) takes the tensor-core route, f32 prefill
        the CUDA-core route, which splits a grid under two blocks an SM (at
        most one split a 64-key tile); g·Sq ≤ 16 takes the decode route in
        either dtype, its kv range split into whole tiles for about two
        blocks an SM (one wave)."""
        want = want_bf16 if dtype == torch.bfloat16 else want_f32
        got = fa_ops.plan(B, Hq, Hkv, Sq, Skv, D, dtype)
        assert tuple(got) == want
        assert got.route in fa_ops.ROUTES
        if got.route == "decode":
            assert (Hq // Hkv) * Sq <= got.bq
            assert got.nsplit <= -(-Skv // fa_ops.KV_TILE)
            assert B * Hkv * got.nsplit <= max(fa_ops.TARGET_BLOCKS, B * Hkv)


# ------------------------------------ the `mma` route's numerics, emulated

LOG2E = 1.4426950408889634


def _emulate_mma_route(q, k, v, mode, window=0, q_offset=0, softcap=0.0):
    """The bf16 prefill route's arithmetic in torch: S = Q·Kᵀ in f32 over
    64-key tiles, scale (and log2 e) applied to S in f32 — q·scale is never
    rounded to bf16 —, an online softmax in the log2 domain from the −1e30
    sentinel, P rounded to bf16 before P·V into an f32 accumulator, and the
    output normalised by 1/max(l, 1e-30) and rounded to bf16."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    g, scale = Hq // Hkv, D ** -0.5
    qf = q.float()
    kf = k.float().repeat_interleave(g, dim=1)
    vf = v.float().repeat_interleave(g, dim=1)
    mask = make_mask(Sq, Skv, mode, window, q_offset)
    m = torch.full((B, Hq, Sq, 1), -1e30)
    l = torch.zeros((B, Hq, Sq, 1))
    acc = torch.zeros((B, Hq, Sq, D))
    for t0 in range(0, Skv, fa_ops.KV_TILE):
        t1 = min(t0 + fa_ops.KV_TILE, Skv)
        s = qf @ kf[:, :, t0:t1].transpose(-1, -2)
        if softcap > 0:
            s = softcap * torch.tanh(s * scale / softcap) * LOG2E
        else:
            s = s * (scale * LOG2E)
        s = s.masked_fill(~mask[:, t0:t1], -torch.inf)
        mn = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha, p = torch.exp2(m - mn), torch.exp2(s - mn)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + p.to(torch.bfloat16).float() @ vf[:, :, t0:t1]
        m = mn
    return (acc / l.clamp_min(1e-30)).to(torch.bfloat16)


class TestMmaRouteNumerics:
    @pytest.mark.parametrize("Sq,Skv,mode,window,q_offset,cap", [
        (150, 150, "causal", 0, 0, 0.0),      # three tiles, the last ragged
        (70, 200, "causal", 0, 130, 0.0),     # a continuation
        (130, 130, "window", 40, 0, 0.0),
        (130, 130, "chunk", 64, 0, 0.0),
        (100, 100, "causal", 0, 0, 30.0),     # softcap
    ])
    def test_emulation_within_bf16_tolerance(self, Sq, Skv, mode, window,
                                             q_offset, cap):
        """llama-like heads (g = 3, D = 128) in bf16: the route's rounding
        of P to bf16 (≈ 2⁻⁹ relative a weight) stays inside the 2e-2 bf16
        tolerance against both plain versions, the port's and the JAX
        reference's."""
        q, k, v = _qkv(Sq + Skv, 1, 6, 2, Sq, Skv, 128)
        q = q * (4.0 if cap else 1.0)
        qt, kt, vt = (torch.as_tensor(x).to(torch.bfloat16) for x in (q, k, v))
        got = _emulate_mma_route(qt, kt, vt, mode, window, q_offset, cap)
        kw = dict(mode=mode, window=window, q_offset=q_offset, logit_softcap=cap)
        want = attention_ref(qt, kt, vt, **kw)
        jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
        oracle = jax_attention_ref(jq, jk, jv, **kw)
        np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                                   **BF16_TOL)
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(oracle, np.float32), **BF16_TOL)


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
