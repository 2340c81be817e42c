"""The port's one-request API against the JAX package's, on the CPU at fp32.

``llama.generate`` (prefill + ``generation.generate_loop``), ``llama.score`` and
``llama.perplexity`` with the ``tiny`` config's JAX ``init_params`` weights converted
for the port. Greedy generation is token for token JAX's, with left-padded masked
prompts and EOS padding; sampled generation draws from torch generators seeded by an
int ``seed`` (JAX takes a key), so it is held to its own contract: reproducible per
seed, in range, the draw of ``sample_logits`` with emission t's generator. Scores and
perplexities agree with JAX's within 1e-5 relative.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from accelerate_tpu import generation as jgen
from accelerate_tpu.models import llama as jl
from accelerate_tpu_torch import generation as tgen
from accelerate_tpu_torch.models import llama as tl
from accelerate_tpu_torch.models.convert import params_from_jax

JCFG = dataclasses.replace(jl.CONFIGS["tiny"], dtype=jnp.float32)
TCFG = dataclasses.replace(tl.CONFIGS["tiny"], dtype=torch.float32)


@pytest.fixture(scope="module")
def setup():
    jparams = jl.init_params(JCFG)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), TCFG, device="cpu")
    rng = np.random.default_rng(1)
    B, S0 = 3, 10
    prompt = rng.integers(1, JCFG.vocab_size, (B, S0)).astype(np.int32)
    mask = np.ones((B, S0), bool)
    mask[0, :4] = mask[1, :2] = False
    prompt[~mask] = 0
    return jparams, tparams, prompt, mask


def _jax_generate(jparams, prompt, mask, **gen):
    out = jl.generate(jparams, jnp.asarray(prompt), JCFG, jgen.GenerationConfig(**gen),
                      prompt_mask=jnp.asarray(mask))
    return np.asarray(out)


def test_greedy_generate_matches_jax(setup):
    """Left-padded masked prompts, 12 new tokens: token for token JAX's; the call
    returns int32 [B, max_new_tokens] on the params' device."""
    jparams, tparams, prompt, mask = setup
    want = _jax_generate(jparams, prompt, mask, max_new_tokens=12)
    got = tl.generate(tparams, prompt, TCFG, tgen.GenerationConfig(max_new_tokens=12),
                      prompt_mask=mask)
    assert got.dtype == torch.int32 and tuple(got.shape) == (3, 12)
    np.testing.assert_array_equal(got.numpy(), want)
    # An unmasked prompt takes the all-True mask, as in JAX.
    want = _jax_generate(jparams, prompt, np.ones_like(mask), max_new_tokens=5)
    got = tl.generate(tparams, torch.from_numpy(prompt), TCFG,
                      tgen.GenerationConfig(max_new_tokens=5))
    np.testing.assert_array_equal(got.numpy(), want)


def test_greedy_generate_eos_padding_matches_jax(setup):
    """An EOS emitted mid-stream by one row (and perhaps by others) is kept and every
    later position is ``pad_token_id``: JAX's ids exactly; with max_new_tokens=1 only
    the prefill's token."""
    jparams, tparams, prompt, mask = setup
    probe = _jax_generate(jparams, prompt, mask, max_new_tokens=12)
    row = probe[2].tolist()
    j = next(j for j in range(3, 12) if row[j] not in row[:j])
    gen = dict(max_new_tokens=12, eos_token_id=row[j], pad_token_id=7)
    want = _jax_generate(jparams, prompt, mask, **gen)
    assert want[2, j] == row[j] and (want[2, j + 1:] == 7).all()
    got = tl.generate(tparams, prompt, TCFG, tgen.GenerationConfig(**gen), prompt_mask=mask)
    np.testing.assert_array_equal(got.numpy(), want)
    one = tl.generate(tparams, prompt, TCFG, tgen.GenerationConfig(max_new_tokens=1),
                      prompt_mask=mask)
    np.testing.assert_array_equal(one.numpy(), probe[:, :1])


def test_sampled_generate_reproducible_per_seed(setup):
    """Sampled generation: the same ids for the same seed (the prefill's cache is reused
    across calls), other ids for another seed, ids in range; emission 0 is
    ``sample_logits`` of the prefill's logits with ``emission_generator(seed, 0)``."""
    _, tparams, prompt, mask = setup
    gen = tgen.GenerationConfig(max_new_tokens=8, temperature=0.9, top_k=20, top_p=0.9)
    a = tl.generate(tparams, prompt, TCFG, gen, seed=3, prompt_mask=mask)
    b = tl.generate(tparams, prompt, TCFG, gen, seed=3, prompt_mask=mask)
    c = tl.generate(tparams, prompt, TCFG, gen, seed=4, prompt_mask=mask)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert ((a >= 0) & (a < TCFG.vocab_size)).all()
    cache = tl.init_cache(TCFG, 3, 64, device="cpu")
    logits, _ = tl.forward_cached(tparams, torch.from_numpy(prompt), cache, TCFG,
                                  token_mask=torch.from_numpy(mask), last_only=True)
    first = tgen.sample_logits(logits[:, -1], gen, tgen.emission_generator(3, 0))
    assert torch.equal(first, a[:, 0])
    assert torch.equal(tl.generate(tparams, prompt, TCFG, gen, prompt_mask=mask),
                       tl.generate(tparams, prompt, TCFG, gen, seed=0, prompt_mask=mask))


def test_sample_logits_contract():
    """Greedy: the int32 argmax; sampled: ``sampling_core`` (the nucleus pass only when
    top_p < 1, as JAX's static gen does), and a generator is required."""
    logits = torch.from_numpy(np.random.default_rng(2).normal(size=(4, 50)).astype(np.float32))
    greedy = tgen.sample_logits(logits, tgen.GenerationConfig(), None)
    assert greedy.dtype == torch.int32 and torch.equal(greedy.long(), logits.argmax(-1))
    gen = tgen.GenerationConfig(temperature=0.7, top_k=9)
    got = tgen.sample_logits(logits, gen, torch.Generator().manual_seed(5))
    want = tgen.sampling_core(logits, torch.Generator().manual_seed(5), 0.7, 1.0, 9,
                              apply_top_p=False)
    assert torch.equal(got.long(), want)
    with pytest.raises(ValueError, match="generator"):
        tgen.sample_logits(logits, gen, None)


@pytest.mark.parametrize("masked", [False, True], ids=["no_mask", "mask"])
def test_score_and_perplexity_match_jax(setup, masked):
    """Per-token log-probs and the perplexity within 1e-5 relative of JAX's; masked
    target positions score exactly 0."""
    jparams, tparams, _, _ = setup
    rng = np.random.default_rng(4)
    tokens = rng.integers(1, JCFG.vocab_size, (3, 16)).astype(np.int32)
    mask = np.ones((3, 16), bool)
    mask[0, :5] = mask[2, :9] = False
    m_j = jnp.asarray(mask) if masked else None
    m_t = torch.from_numpy(mask) if masked else None
    want = np.asarray(jl.score(jparams, jnp.asarray(tokens), JCFG, m_j))
    got = tl.score(tparams, torch.from_numpy(tokens), TCFG, m_t).detach().numpy()
    assert got.shape == (3, 15) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    if masked:
        assert (got[~mask[:, 1:]] == 0.0).all()
    want_p = float(jl.perplexity(jparams, jnp.asarray(tokens), JCFG, m_j))
    got_p = float(tl.perplexity(tparams, torch.from_numpy(tokens), TCFG, m_t))
    np.testing.assert_allclose(got_p, want_p, rtol=1e-5)


def test_generate_caches_released_and_bounded_in_bytes(setup, monkeypatch):
    """``generate`` keeps its (prefill, decode) pair and the KV cache it holds for later
    calls; ``Accelerator.free_memory()`` empties that cache; under a bound of a few
    bytes a new entry evicts the least recently used one, and a call after an eviction
    builds a new cache and gives the same tokens."""
    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState

    _, tparams, prompt, mask = setup
    tgen.release_generate_caches()

    def run(n):
        return tl.generate(tparams, prompt, TCFG, tgen.GenerationConfig(max_new_tokens=n),
                           prompt_mask=mask)

    first = run(4)
    assert [k[:3] for k in tgen._GEN_CACHE] == [("fns", TCFG, 64)]
    held = tgen.held_bytes()
    assert held >= 2 * TCFG.n_layers * 3 * 64 * TCFG.n_kv_heads * TCFG.head_dim * 4
    # A second batch size keeps a second cache in the same pair.
    tl.generate(tparams, prompt[:2], TCFG, tgen.GenerationConfig(max_new_tokens=4),
                prompt_mask=mask[:2])
    assert len(tgen._GEN_CACHE) == 1 and tgen.held_bytes() > held
    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()
    try:
        Accelerator(device="cpu").free_memory()
    finally:
        for cls in (AcceleratorState, GradientState, PartialState):
            cls._reset_state()
    assert len(tgen._GEN_CACHE) == 0 and tgen.held_bytes() == 0
    assert tgen.generate_loop.last_step is None

    monkeypatch.setattr(tgen, "GENERATE_CACHE_BYTES", 16)
    run(4)
    run(60)  # a 128-slot cache: evicts the 64-slot pair, least recently used
    assert [k[2] for k in tgen._GEN_CACHE] == [128]
    assert torch.equal(run(4), first)
    assert [k[2] for k in tgen._GEN_CACHE] == [64]
    monkeypatch.setattr(tgen, "GENERATE_CACHE_BYTES", 2 * held + tgen.held_bytes())
    run(60)
    assert [k[2] for k in tgen._GEN_CACHE] == [64, 128]
    tgen.release_generate_caches()
