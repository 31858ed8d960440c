"""The port's LM tier held to `repro` on both ported architectures.

On the smoke configurations of llama3.2-3b (dense GQA attention, K8) and
mamba2-130m (Mamba-2, K9), in f32, the reference's random parameters go
through `convert.lm_params` into the port, and the two are compared:
`prefill` logits and caches, `decode_step` logits over several positions,
and whole greedy `ServeEngine.run` calls (mixed prompt lengths, a wave
that drains, a mid-wave refill, truncation at ``max_len``, one slot).

Tolerances: logits rtol/atol 1e-4 (f32 sums in another order through a
few layers). Tokens follow the margin rule of the earlier slices: at each
engine step, rows whose reference top-1 logit beats the runner-up by more
than `MARGIN` must pick the same token; once a row falls under it, the two
runs may part and the comparison stops there.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import get_smoke_config as ref_smoke_config
from repro.models import build_model as ref_build_model
from repro.models.common import apply_rope as ref_apply_rope
from repro.models.common import rmsnorm as ref_rmsnorm
from repro.serve.engine import Request as RefRequest
from repro.serve.engine import ServeEngine as RefEngine

from repro_torch import convert
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import LM, build_model
from repro_torch.models.common import apply_rope, rmsnorm
from repro_torch.serve.engine import Request, ServeEngine

ARCHS = ("llama3.2-3b", "mamba2-130m")
TOL = dict(rtol=1e-4, atol=1e-4)
MARGIN = 1e-3
CPU = torch.device("cpu")


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(arch, reference model, its params, the port's model with them)."""
    arch = request.param
    ref_cfg = ref_smoke_config(arch).with_(dtype="float32")
    ref = ref_build_model(ref_cfg)
    params, _ = ref.init(jax.random.PRNGKey(3))
    params_np = jax.tree.map(np.asarray, params)
    cfg = get_smoke_config(arch).with_(dtype="float32")
    mine = build_model(cfg).load(convert.lm_params(params_np, cfg), device=CPU)
    return arch, ref, params, mine


def _tokens(seed, B, S, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (B, S))


class TestConfigs:
    @pytest.mark.parametrize("arch", ARCHS)
    def test_configs_equal_reference(self, arch):
        for mine, ref in ((get_config(arch), ref_get_config(arch)),
                          (get_smoke_config(arch), ref_smoke_config(arch))):
            ref_fields = dataclasses.asdict(ref)
            for name, value in dataclasses.asdict(mine).items():
                assert ref_fields[name] == value, name
            assert mine.padded_vocab == ref.padded_vocab
            assert mine.resolved_head_dim == ref.resolved_head_dim

    @pytest.mark.parametrize("arch", ["llama3-8b", "qwen3-moe-30b-a3b",
                                      "recurrentgemma-2b", "whisper-large-v3"])
    def test_other_archs_are_not_ported_yet(self, arch):
        with pytest.raises(NotImplementedError, match="not yet ported"):
            get_config(arch)
        with pytest.raises(ValueError, match="unknown arch"):
            get_config("gpt-2")


class TestLM:
    def test_state_dict_covers_every_parameter(self, pair):
        _, ref, params, mine = pair
        n_ref = sum(np.asarray(x).size for x in jax.tree.leaves(params))
        assert sum(p.numel() for p in mine.parameters()) == n_ref

    @pytest.mark.parametrize("B,S", [(1, 5), (3, 17)])
    def test_prefill_matches_reference(self, pair, B, S):
        arch, ref, params, mine = pair
        toks = _tokens(S, B, S, mine.cfg.vocab_size)
        max_len = S + 6
        lr, cr = ref.prefill(params, {"tokens": jnp.asarray(toks, jnp.int32)},
                             max_len=max_len)
        lm, cm = mine.prefill({"tokens": torch.as_tensor(toks)}, max_len=max_len)
        np.testing.assert_allclose(lm.numpy(), np.asarray(lr), **TOL)
        want = convert.lm_cache(jax.tree.map(np.asarray, cr), mine.cfg,
                                device=CPU)
        assert len(cm) == len(want) == mine.cfg.n_layers
        for layer, layer_r in zip(cm, want):
            assert layer.keys() == layer_r.keys()
            for name in layer:
                assert layer[name].shape == layer_r[name].shape
                np.testing.assert_allclose(layer[name].numpy(),
                                           layer_r[name].numpy(), **TOL)

    def test_decode_steps_match_reference(self, pair):
        arch, ref, params, mine = pair
        B, S, steps, max_len = 2, 7, 4, 16
        toks = _tokens(11, B, S + steps, mine.cfg.vocab_size)
        _, cr = ref.prefill(params, {"tokens": jnp.asarray(toks[:, :S], jnp.int32)},
                            max_len=max_len)
        _, cm = mine.prefill({"tokens": torch.as_tensor(toks[:, :S])},
                             max_len=max_len)
        decode = jax.jit(ref.decode_step)
        for t in range(S, S + steps):
            lr, cr = decode(params, cr, jnp.asarray(toks[:, t:t + 1], jnp.int32),
                            jnp.int32(t))
            lm, cm = mine.decode_step(cm, torch.as_tensor(toks[:, t:t + 1]), t)
            np.testing.assert_allclose(lm.numpy(), np.asarray(lr), **TOL)
            # decode at position t = prefill of the prompt extended to t + 1
            lp, _ = mine.prefill({"tokens": torch.as_tensor(toks[:, :t + 1])},
                                 max_len=max_len)
            np.testing.assert_allclose(lm.numpy(), lp.numpy(), **TOL)

    def test_init_uses_reference_scales(self):
        cfg = get_smoke_config("llama3.2-3b").with_(d_model=256, n_heads=8,
                                                    n_kv_heads=4, head_dim=32,
                                                    d_ff=512)
        m = LM(cfg).init(seed=1, device=CPU)
        emb = m.io["embedding"].float()
        assert m.io["embedding"].dtype == torch.bfloat16  # the config's dtype
        assert abs(float(emb.std()) - cfg.d_model ** -0.5) < 0.05 * cfg.d_model ** -0.5
        wq = m.blocks[0].attn["wq"].float()
        assert abs(float(wq.std()) - cfg.d_model ** -0.5) < 0.05 * cfg.d_model ** -0.5
        wo = m.blocks[0].attn["wo"].float()      # fan_in = the first axis (H)
        assert abs(float(wo.std()) - cfg.n_heads ** -0.5) < 0.05 * cfg.n_heads ** -0.5
        assert not m.blocks[1].norm_1["scale"].any()
        assert not m.final_norm["scale"].any()
        again = LM(cfg).init(seed=1, device=CPU)
        assert torch.equal(again.io["embedding"], m.io["embedding"])
        ms = LM(get_smoke_config("mamba2-130m")).init(seed=1, device=CPU)
        assert torch.equal(ms.blocks[0].ssm["D_skip"],
                           torch.ones_like(ms.blocks[0].ssm["D_skip"]))
        assert not ms.blocks[0].ssm["A_log"].any()


class TestCommon:
    def test_rmsnorm_scales_by_one_plus_gamma(self):
        rng = np.random.default_rng(0)
        x = rng.standard_normal((3, 8)).astype(np.float32)
        gamma = rng.standard_normal(8).astype(np.float32)
        got = rmsnorm(torch.as_tensor(x), torch.as_tensor(gamma), 1e-5).numpy()
        want = x / np.sqrt((x * x).mean(-1, keepdims=True) + 1e-5) * (1 + gamma)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(
            got, np.asarray(ref_rmsnorm(jnp.asarray(x), jnp.asarray(gamma))),
            rtol=1e-6, atol=1e-6)
        zero = rmsnorm(torch.as_tensor(x), torch.zeros(8)).numpy()  # γ = 0: unit gain
        np.testing.assert_allclose((zero ** 2).mean(-1), 1.0, rtol=1e-4)

    def test_rope_rotates_halves(self):
        rng = np.random.default_rng(1)
        x = rng.standard_normal((2, 3, 5, 8)).astype(np.float32)
        pos = rng.integers(0, 50, (2, 5))
        got = apply_rope(torch.as_tensor(x), torch.as_tensor(pos), 1e4).numpy()
        freqs = 1.0 / 1e4 ** (np.arange(0, 8, 2) / 8)
        ang = pos[:, None, :, None] * freqs
        x1, x2 = x[..., :4], x[..., 4:]
        want = np.concatenate([x1 * np.cos(ang) - x2 * np.sin(ang),
                               x2 * np.cos(ang) + x1 * np.sin(ang)], -1)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(
            got, np.asarray(ref_apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4)),
            rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------- serving

class _Recorder:
    """A model proxy that keeps the logits of every call the engine makes
    (the reference's engine jits `decode_step`, so its decode calls are
    recorded around the jitted function instead)."""

    def __init__(self, model, calls, record_decode=True):
        self._model = model
        self.calls = calls
        self.record_decode = record_decode
        self.device = getattr(model, "device", None)

    def prefill(self, *args, **kw):
        logits, cache = self._model.prefill(*args, **kw)
        self.calls.append(np.array(logits, np.float32))
        return logits, cache

    def decode_step(self, *args):
        logits, cache = self._model.decode_step(*args)
        if self.record_decode:
            self.calls.append(np.array(logits, np.float32))
        return logits, cache


def _serve(pair, prompts, budgets, batch_size, max_len):
    """Both engines on the same greedy requests → (ref requests, mine,
    ref engine, my engine, ref logits calls, my logits calls)."""
    arch, ref, params, mine = pair
    ref_calls, my_calls = [], []
    ref_engine = RefEngine(_Recorder(ref, ref_calls, record_decode=False), params,
                           batch_size=batch_size, max_len=max_len)
    decode = ref_engine._decode

    def recorded_decode(*args):
        logits, cache = decode(*args)
        ref_calls.append(np.asarray(logits))
        return logits, cache

    ref_engine._decode = recorded_decode
    ref_reqs = [RefRequest(prompt=list(p), max_new_tokens=n)
                for p, n in zip(prompts, budgets)]
    ref_engine.run(ref_reqs)
    my_engine = ServeEngine(_Recorder(mine, my_calls), batch_size=batch_size,
                            max_len=max_len, device=CPU)
    my_reqs = [Request(prompt=list(p), max_new_tokens=n)
               for p, n in zip(prompts, budgets)]
    my_engine.run(my_reqs)
    return ref_reqs, my_reqs, ref_engine, my_engine, ref_calls, my_calls


def _assert_same_serving(out):
    ref_reqs, my_reqs, ref_engine, my_engine, ref_calls, my_calls = out
    parted = False
    for lr, lm in zip(ref_calls, my_calls):
        top2 = np.sort(lr, axis=-1)[:, -2:]
        if ((top2[:, 1] - top2[:, 0]) <= MARGIN).any():
            parted = True  # a near tie: the runs may part from here on
            break
        assert lr.shape == lm.shape
        np.testing.assert_array_equal(lm.argmax(-1), lr.argmax(-1))
        np.testing.assert_allclose(lm, lr, **TOL)
    if not parted:
        assert len(ref_calls) == len(my_calls)
        assert [r.out_tokens for r in my_reqs] == [r.out_tokens for r in ref_reqs]
        assert [r.done for r in my_reqs] == [r.done for r in ref_reqs]
        assert my_engine.refill_count == ref_engine.refill_count
    return parted


class TestServeEngine:
    def test_mixed_prompts_in_waves_that_drain(self, pair):
        vocab = pair[3].cfg.vocab_size
        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, vocab, n).tolist() for n in (3, 9, 5, 12, 2)]
        out = _serve(pair, prompts, [5, 3, 6, 4, 5], batch_size=3, max_len=24)
        assert not _assert_same_serving(out)
        assert all(r.done for r in out[1])
        assert [len(r.out_tokens) for r in out[1]] == [5, 3, 6, 4, 5]

    def test_mid_wave_refill(self, pair):
        prompts = [[1, 2, 3], [4, 5, 6], [7, 8]]
        out = _serve(pair, prompts, [2, 10, 4], batch_size=2, max_len=48)
        assert not _assert_same_serving(out)
        assert out[3].refill_count == 1
        assert [len(r.out_tokens) for r in out[1]] == [2, 10, 4]

    def test_truncation_at_max_len(self, pair):
        prompts = [[5, 6, 7, 8, 9], [3, 4]]
        out = _serve(pair, prompts, [8, 8], batch_size=2, max_len=9)
        assert not _assert_same_serving(out)
        # the wave starts at position 5 and stops when the cache is full
        assert [len(r.out_tokens) for r in out[1]] == [5, 5]
        assert all(r.done for r in out[1])

    def test_one_slot(self, pair):
        prompts = [[2, 4, 6], [9, 3, 1], [7, 7, 7, 7]]
        out = _serve(pair, prompts, [3, 4, 2], batch_size=1, max_len=32)
        assert not _assert_same_serving(out)
        assert [len(r.out_tokens) for r in out[1]] == [3, 4, 2]

    def test_temperature_rows_share_a_wave(self, pair):
        """Greedy rows keep their greedy tokens beside sampled rows; the
        sampled ones come from the engine's seeded generator."""
        mine = pair[3]
        vocab = mine.cfg.vocab_size

        def run(temps, seed):
            reqs = [Request(prompt=[1, 2, 3, i], max_new_tokens=6, temperature=t)
                    for i, t in enumerate(temps)]
            ServeEngine(mine, batch_size=3, max_len=16, seed=seed,
                        device=CPU).run(reqs)
            return [r.out_tokens for r in reqs]

        greedy = run([0.0, 0.0, 0.0], 0)
        mixed = run([0.0, 1.5, 0.0], 0)
        assert mixed[0] == greedy[0] and mixed[2] == greedy[2]
        assert all(0 <= t < vocab for t in mixed[1])
        assert run([0.0, 1.5, 0.0], 0) == mixed
        assert run([5.0, 5.0, 5.0], 1) != run([5.0, 5.0, 5.0], 2)


class TestDevices:
    def test_entry_points_default_to_cuda(self, pair):
        from repro_torch.launch import serve as launch_serve

        cfg = get_smoke_config("llama3.2-3b")
        if torch.cuda.is_available():
            model = LM(cfg).init()
            assert model.device.type == "cuda"
            assert ServeEngine(model, 1, 8).device.type == "cuda"
            return
        with pytest.raises(RuntimeError, match="device='cpu'"):
            LM(cfg).init()
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ServeEngine(pair[3], 1, 8)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            launch_serve.main(["--smoke"])

    def test_launcher_serves_on_the_cpu(self, capsys):
        from repro_torch.launch import serve as launch_serve

        reqs = launch_serve.main(["--arch", "mamba2-130m", "--smoke", "--device",
                                  "cpu", "--requests", "3", "--new-tokens", "4"])
        assert [len(r.out_tokens) for r in reqs] == [4, 4, 4]
        assert "served 3 requests, 12 tokens" in capsys.readouterr().out
