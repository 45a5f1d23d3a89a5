"""Port parity of the dense-LM serving slice on the CPU.

The reference's parameters (``init_split`` from a JAX key) cross into the
port's ``LM`` through ``interop.lm_params_from_reference``, prompts are
drawn once with numpy, and both packages prefill and then decode greedily,
each decode step fed the reference's token.  Covered: the four dense
reduced configs (granite's vocab of 515 exercises the padded-vocab mask,
chatglm's ``rope_fraction`` 0.5 the half rotary), the configs and the
registry, the parameter count, the port's own prefill/decode golden test,
the initialisation's distribution and the launcher.

Bars:
  * f32 with f32 probabilities (``attn_probs_bf16=False``): logits within
    1e-4 at every step and equal greedy tokens.  This is the algorithm in
    f32 end to end.
  * f32 with the configs' default bf16 probabilities in the plain prefill
    attention: a probability may round to the neighbouring bf16 value in
    the two frameworks (their f32 exp differ in the last bits), one bf16
    step (2^-8) of an attention weight, so logits within 2^-8 of their
    largest magnitude.
  * bf16 (the configs' dtype): the frameworks round to bf16 at different
    places (elementwise ops, matmul outputs); a few bf16 steps of the
    logits' scale accumulate over two layers, so logits within 2^-5 of
    their largest magnitude.
  * the golden test: < 1e-4, the reference's bar
    (``tests/test_serving.py:58-64``), in bf16 as the reference runs it
    and in f32 with f32 probabilities.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.configs import get_reduced_config as ref_reduced_config
from repro.configs import ARCHS as REF_ARCHS
from repro.models import config as jconfig
from repro.models import init_split
from repro.models import lm as jlm
from repro_torch import kernels as tkernels
from repro_torch.configs import ARCHS, get_config, get_reduced_config
from repro_torch.interop import lm_params_from_reference, to_numpy
from repro_torch.launch import serve as tserve
from repro_torch.models import build, param_count

REPO = Path(__file__).resolve().parents[1]
DENSE = ["llama3.2-3b", "granite-3-2b", "chatglm3-6b", "internlm2-20b"]
B, PROMPT, GEN = 2, 12, 6


def _pair(arch, **overrides):
    jcfg = dataclasses.replace(ref_reduced_config(arch), **overrides)
    tcfg = dataclasses.replace(get_reduced_config(arch), **overrides)
    values, _ = init_split(jcfg, jax.random.PRNGKey(0))
    values = jax.tree.map(np.asarray, values)
    return jcfg, values, lm_params_from_reference(values, tcfg, device="cpu")


def _serve_both(arch, **overrides):
    """Prefill then GEN greedy decode steps in both packages, both fed the
    reference's tokens.  Returns (max abs logit error, largest logit,
    greedy tokens equal at every step)."""
    jcfg, values, model = _pair(arch, **overrides)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, jcfg.vocab_size, (B, PROMPT)).astype(np.int32)
    jl, jcache = jlm.prefill(values, jcfg, jnp.asarray(prompts), cache_len=PROMPT + GEN)
    tl, tcache = model.prefill(torch.from_numpy(prompts).long(), cache_len=PROMPT + GEN)
    errs, scale, same = [], 0.0, []
    for i in range(GEN + 1):
        jn, tn = np.asarray(jl), to_numpy(tl)
        assert tn.shape == (B, jcfg.padded_vocab) and tn.dtype == np.float32
        errs.append(np.abs(jn - tn).max())
        scale = max(scale, np.abs(jn[:, : jcfg.vocab_size]).max())
        jt, tt = jn.argmax(-1), tn.argmax(-1)
        same.append(bool((jt == tt).all()))
        if i == GEN:
            break
        tok = jt[:, None].astype(np.int32)
        jl, jcache = jlm.decode_step(values, jcfg, jnp.asarray(tok), jcache, PROMPT + i)
        tl, tcache = model.decode_step(torch.from_numpy(tok).long(), tcache, PROMPT + i)
    return max(errs), scale, all(same)


@pytest.mark.parametrize("arch", DENSE)
def test_slice_matches_reference_f32(arch):
    err, _, same = _serve_both(arch, dtype="float32", attn_probs_bf16=False)
    assert err <= 1e-4, err
    assert same


@pytest.mark.parametrize("arch", DENSE)
def test_slice_matches_reference_f32_bf16_probs(arch):
    err, scale, _ = _serve_both(arch, dtype="float32")
    assert err <= 2.0 ** -8 * scale, (err, scale)


@pytest.mark.parametrize("arch", DENSE)
def test_slice_matches_reference_bf16(arch):
    err, scale, _ = _serve_both(arch)
    assert err <= 2.0 ** -5 * scale, (err, scale)


def test_padded_vocab_is_masked():
    jcfg, _, model = _pair("granite-3-2b", dtype="float32")
    assert jcfg.vocab_size == 515 and jcfg.padded_vocab == 768
    logits, _ = model.prefill(torch.zeros(1, 4, dtype=torch.long))
    assert torch.all(logits[:, 515:] == -1e30)
    assert torch.all(logits[:, :515] > -1e3)


@pytest.mark.parametrize("arch", ["llama3.2-3b", "chatglm3-6b"])
def test_flash_prefill_matches_reference_kernel_path(arch):
    """Prefill through the flash path in both packages: the port's wrapper
    (its plain version on the CPU) against the reference's Pallas kernel
    in interpret mode.  The kernel keeps f32 probabilities in both."""
    jcfg, values, model = _pair(arch, dtype="float32")
    prompts = np.random.default_rng(1).integers(0, jcfg.vocab_size, (B, 20)).astype(np.int32)
    want, _, _ = jlm.forward(values, jcfg, jnp.asarray(prompts), mode="prefill",
                             use_flash=True)
    got, _ = model.prefill(torch.from_numpy(prompts).long(), use_kernel=True)
    np.testing.assert_allclose(to_numpy(got), np.asarray(want)[:, -1], atol=1e-4, rtol=0)


def test_full_depth_flash_path_within_serving_bars():
    """chip_smoke.py's serving check at full depth on the CPU: llama3.2-3b's
    28 layers at a narrow width (d_model 256) in bf16, prefilled through
    the flash path (the kernel's plain version: f32 probabilities) and
    through plain attention (bf16 probabilities): the last-position
    logits stay within the smoke's bars (relative L2 0.05, max abs 0.08
    of the largest logit)."""
    cfg = dataclasses.replace(get_config("llama3.2-3b"), d_model=256, num_heads=8,
                              num_kv_heads=2, d_ff=1024, vocab_size=4096)
    model = build(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    prompts = torch.randint(0, cfg.vocab_size, (2, 256), generator=torch.Generator().manual_seed(1))
    lk, _ = model.prefill(prompts, use_kernel=True)
    lp, _ = model.prefill(prompts, use_kernel=False)
    rel_l2 = ((lk - lp).norm() / lp.norm()).item()
    max_abs = (lk - lp).abs().max().item() / lp.abs().max().item()
    assert len(model.blocks) == 28
    assert 0 < rel_l2 <= 0.05 and max_abs <= 0.08, (rel_l2, max_abs)


def _golden_errors(arch, dtype):
    """The port's prefill + step-by-step decode against its own
    teacher-forced forward (``tests/test_serving.py::_decode_errors``).

    In f32 the probabilities are f32 too: with ``attn_probs_bf16`` the
    train/prefill attention rounds them to bf16 while decode casts them to
    the cache's dtype, which is f32 there.  The reference does the same
    (its golden test runs in bf16, where both round; in f32 it is 1.3e-2
    apart), and the port mirrors it (ROADMAP C)."""
    cfg = dataclasses.replace(get_reduced_config(arch), dtype=dtype,
                              attn_probs_bf16=dtype == "bfloat16")
    model = build(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    s, prompt = 24, 16
    tokens = torch.randint(0, cfg.vocab_size, (B, s), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        full, _ = model(tokens, mode="train")
    last, cache = model.prefill(tokens[:, :prompt], cache_len=s)
    errs = [(last - full[:, prompt - 1]).abs().max().item()]
    for t in range(prompt, s):
        logit, cache = model.decode_step(tokens[:, t:t + 1], cache, t)
        errs.append((logit - full[:, t]).abs().max().item())
    return errs


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("arch", DENSE)
def test_prefill_decode_matches_forward(arch, dtype):
    errs = _golden_errors(arch, dtype)
    assert max(errs) < 1e-4, errs


def test_train_mode_takes_plain_attention_and_trains_wq(monkeypatch):
    """Train takes plain attention in every layer (B8 has no backward), so
    wq, wk and wv get a gradient through attention; forcing the kernel in
    train is refused."""
    from repro_torch.models import layers as tlayers

    cfg = dataclasses.replace(get_reduced_config("llama3.2-3b"), dtype="float32")
    model = build(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    seen, attention = [], tlayers.kops.attention
    monkeypatch.setattr(tlayers.kops, "attention",
                        lambda *a, use_kernel, **k: seen.append(use_kernel)
                        or attention(*a, use_kernel=use_kernel, **k))
    tokens = torch.randint(0, cfg.vocab_size, (B, 16), generator=torch.Generator().manual_seed(1))
    logits, _ = model(tokens, mode="train")
    torch.logsumexp(logits, -1).mean().backward()
    assert seen == [False] * cfg.num_layers
    for blk in model.blocks:
        for w in (blk.mixer.wq, blk.mixer.wk, blk.mixer.wv):
            assert w.grad is not None and w.grad.abs().max().item() > 0
    with pytest.raises(ValueError, match="no backward"):
        model(tokens, mode="train", use_kernel=True)


# ------------------------------------------------------ configs, counts ----
@pytest.mark.parametrize("arch", DENSE)
def test_configs_match_reference(arch):
    for got, want in ((get_config(arch), ref_config(arch)),
                      (get_reduced_config(arch), ref_reduced_config(arch))):
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.stages() == want.stages()
        assert (got.head_dim, got.padded_vocab) == (want.head_dim, want.padded_vocab)


@pytest.mark.parametrize("arch", DENSE)
def test_param_count_matches_reference(arch):
    """Arithmetic only: the full configs allocate nothing."""
    assert param_count(get_config(arch)) == jconfig.param_count(ref_config(arch))


@pytest.mark.parametrize("arch", DENSE)
def test_module_holds_param_count(arch):
    """The reduced LM's tensors hold ``param_count`` plus the padded vocab
    rows of the embedding and the unembedding."""
    cfg = get_reduced_config(arch)
    model = build(cfg, device="cpu")
    extra = 2 * (cfg.padded_vocab - cfg.vocab_size) * cfg.d_model
    assert sum(p.numel() for p in model.parameters()) == param_count(cfg) + extra
    assert len(model.blocks) == cfg.num_layers


def test_registry_knows_every_arch_and_refuses_unported():
    assert set(ARCHS) == set(REF_ARCHS)
    for arch in sorted(set(ARCHS) - set(DENSE)):
        for get in (get_config, get_reduced_config):
            with pytest.raises(NotImplementedError, match=r"ROADMAP A11-"):
                get(arch)
    with pytest.raises(KeyError):
        get_config("gpt-5")


def test_init_follows_reference_distribution():
    """Fan-in-scaled standard normal truncated to [-2, 2]
    (``repro/models/layers.py:70-81``): std 0.8796 / sqrt(fan_in), bounded
    by 2 / sqrt(fan_in); norms zero; the cast is to the config's dtype."""
    cfg = dataclasses.replace(get_reduced_config("internlm2-20b"), d_ff=1024)
    model = build(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    sigma = 0.8796256610342398  # std of N(0, 1) truncated to [-2, 2]
    for w, fan_in in ((model.blocks[0].mlp.wi, cfg.d_model),
                      (model.blocks[0].mlp.wo, cfg.d_ff),
                      (model.embed, cfg.d_model)):
        assert w.dtype == torch.bfloat16
        std = w.float().std().item() * fan_in ** 0.5
        assert abs(std - sigma) < 0.02, std
        assert w.float().abs().max().item() <= 2.0 / fan_in ** 0.5 * (1 + 2 ** -8)
    assert model.blocks[0].norm1.dtype == torch.float32
    assert not model.blocks[0].norm1.any() and not model.final_norm.any()


def test_unported_model_pieces_are_refused():
    from repro_torch.models.lm import LM

    cfg = get_reduced_config("llama3.2-3b")
    for overrides, item in (({"num_experts": 4, "num_experts_per_token": 2}, "A11-moe"),
                            ({"block_pattern": ("attn", "local_attn")}, "A11-hybrid"),
                            ({"block_pattern": ("ssd",), "ssm_state_dim": 8}, "A11-ssm")):
        with pytest.raises(NotImplementedError, match=item):
            LM(dataclasses.replace(cfg, **overrides), device="cpu")


# ------------------------------------------------------------- launcher ----
def test_serve_on_cpu_returns_token_matrix():
    tkernels.reset_launch_counts()
    toks, stats = tserve.serve("granite-3-2b", batch=3, prompt_len=10, gen=5, device="cpu")
    assert toks.shape == (3, 5) and toks.dtype == torch.int64
    assert int(toks.min()) >= 0 and int(toks.max()) < 515
    assert stats["prefill_s"] > 0 and stats["decode_s"] > 0
    assert stats["flash_launches"] == {"prefill": 0, "decode": 0}  # CPU: plain only
    again, _ = tserve.serve("granite-3-2b", batch=3, prompt_len=10, gen=5, device="cpu")
    assert torch.equal(toks, again)  # seeded weights and prompts


def test_serve_refuses_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.serve("llama3.2-3b", device="cuda")


def _cli(*args):
    env = {"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"}
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *args], env=env,
        capture_output=True, text=True, timeout=300,
    )


def test_cli_serves_on_cpu():
    proc = _cli("--arch", "chatglm3-6b", "--device", "cpu", "--batch", "2",
                "--prompt-len", "8", "--gen", "3")
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[0] == "generated token matrix: (2, 3)"
    stats = dict(line.split(": ", 1) for line in lines[2:])
    assert stats["device"] == "cpu"
    assert stats["config"].startswith("chatglm3-6b layers=2")
    assert stats["flash_launches_prefill"] == "0"
    assert float(stats["decode_tokens_per_s"]) > 0


@pytest.mark.parametrize("args,needle", [
    (("--arch", "recurrentgemma-2b", "--device", "cpu"), "ROADMAP A11-hybrid"),
    (("--arch", "mamba2-370m", "--device", "cpu"), "ROADMAP A11-ssm"),
    (("--arch", "kimi-k2-1t-a32b", "--device", "cpu"), "ROADMAP A11-moe"),
    (("--arch", "whisper-tiny", "--device", "cpu"), "ROADMAP A11-whisper"),
])
def test_cli_refuses_unported(args, needle):
    proc = _cli(*args)
    assert proc.returncode == 2
    assert needle in proc.stderr
