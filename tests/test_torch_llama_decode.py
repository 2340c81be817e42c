"""The port's llama cached forwards against the JAX package's, on the CPU at fp32.

Params come from the JAX ``init_params`` (stacked ``scan_layers`` and unstacked),
converted by ``convert.params_from_jax``; token inputs are seeded numpy. Compared:
``forward_cached`` prefill logits over left-padded rows (pads masked), then
``forward_slots_paged`` decode at T=1 and T=3 through the paged pool, with plain and
int8 (``kv_quant``) caches, and a tiny variant with Llama-3.1 rope scaling, q/k/v
biases and the Gemma knobs (alternating sliding window, softcaps, post-norm,
zero-centred norms, embedding scale, GeGLU, tied embeddings, a head-dim override).

Tolerance: logits rtol = atol = 1e-5 at fp32 (the two frameworks' matmuls and
transcendentals round differently in the last bits).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from accelerate_tpu.models import llama as jl
from accelerate_tpu_torch.models import llama as tl
from accelerate_tpu_torch.models.convert import params_from_jax

TOL = dict(rtol=1e-5, atol=1e-5)

KNOBS = dict(
    rope_scaling="llama3", qkv_bias=True, sliding_window=4, window_every=2,
    attn_softcap=20.0, final_softcap=15.0, post_norm=True, norm_plus_one=True,
    embed_scale=True, mlp_act="gelu", tie_embeddings=True, head_dim_override=48,
    attn_scale=0.2,
)


def _configs(scan_layers=False, kv_quant=False, knobs=False):
    kw = dict(scan_layers=scan_layers, kv_quant=kv_quant, **(KNOBS if knobs else {}))
    return (dataclasses.replace(jl.CONFIGS["tiny"], dtype=jnp.float32, **kw),
            dataclasses.replace(tl.CONFIGS["tiny"], dtype=torch.float32, **kw))


def _params(jcfg, tcfg, perturb=False):
    """JAX params (as numpy) and the port's conversion of them. ``perturb`` fills the
    zero-initialized biases and zero-centred norm weights with seeded noise so the
    knobs that read them are exercised."""
    np_params = jax.tree.map(np.asarray, jl.init_params(jcfg, jax.random.PRNGKey(1)))
    if perturb:
        rng = np.random.default_rng(9)

        def noisy(layer):
            return {k: (v + 0.1 * rng.standard_normal(v.shape)).astype(np.float32)
                    if k.startswith(("ln_", "bq", "bk", "bv")) else v
                    for k, v in layer.items()}

        layers = np_params["layers"]
        np_params["layers"] = (noisy(layers) if isinstance(layers, dict)
                               else [noisy(layer) for layer in layers])
        np_params["ln_f"] = noisy({"ln_f": np_params["ln_f"]})["ln_f"]
    jparams = jax.tree.map(jnp.asarray, np_params)
    return jparams, params_from_jax(np_params, tcfg, device="cpu")


def _prompts(vocab, B=2, T=12, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, vocab, (B, T)).astype(np.int32)
    mask = np.ones((B, T), bool)
    mask[1, :5] = False  # row 1 left-padded by 5
    return tokens, mask


def _close(got, want):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want), **TOL)


def _run_pair(jcfg, tcfg, jparams, tparams):
    """Prefill (forward_cached) then paged decode at T=3 and T=1 on both sides."""
    tokens, mask = _prompts(jcfg.vocab_size)
    B, max_len, ps = 2, 32, 4
    jlog, jcache = jl.forward_cached(jparams, jnp.asarray(tokens),
                                     jl.init_cache(jcfg, B, max_len), jcfg,
                                     token_mask=jnp.asarray(mask))
    tlog, tcache = tl.forward_cached(tparams, torch.from_numpy(tokens),
                                     tl.init_cache(tcfg, B, max_len, device="cpu"), tcfg,
                                     token_mask=torch.from_numpy(mask))
    _close(tlog, jlog)
    assert tcache["index"] == int(jcache["index"])
    np.testing.assert_array_equal(tcache["valid"].numpy(), np.asarray(jcache["valid"]))

    MP = max_len // ps
    tables = np.arange(B * MP, dtype=np.int32).reshape(B, MP)[::-1].copy()
    tables[0, MP - 1] = B * MP  # an unallocated logical page (sentinel)
    jpaged = jl.init_paged_cache(jcfg, B, max_len, B * MP, ps)
    tpaged = tl.init_paged_cache(tcfg, B, max_len, B * MP, ps, device="cpu")
    rng = np.random.default_rng(4)
    pos = np.array([0, 6], np.int32)
    for T in (3, 1, 1, 3, 1):
        toks = rng.integers(1, jcfg.vocab_size, (B, T)).astype(np.int32)
        jlog, jpaged = jl.forward_slots_paged(jparams, jnp.asarray(toks), jpaged,
                                              jnp.asarray(tables), jnp.asarray(pos), jcfg, ps)
        tlog, tpaged = tl.forward_slots_paged(tparams, torch.from_numpy(toks), tpaged,
                                              torch.from_numpy(tables),
                                              torch.from_numpy(pos), tcfg, ps)
        _close(tlog, jlog)
        pos = pos + T
    np.testing.assert_array_equal(tpaged["valid"].numpy(), np.asarray(jpaged["valid"]))


@pytest.mark.parametrize("scan_layers", [False, True], ids=["unstacked", "stacked"])
def test_forward_matches_jax(scan_layers):
    jcfg, tcfg = _configs(scan_layers=scan_layers)
    _run_pair(jcfg, tcfg, *_params(jcfg, tcfg))


def test_kv_quant_forward_matches_jax():
    jcfg, tcfg = _configs(kv_quant=True)
    _run_pair(jcfg, tcfg, *_params(jcfg, tcfg))


@pytest.mark.parametrize("scan_layers", [False, True], ids=["unstacked", "stacked"])
def test_knobs_forward_matches_jax(scan_layers):
    jcfg, tcfg = _configs(scan_layers=scan_layers, knobs=True)
    _run_pair(jcfg, tcfg, *_params(jcfg, tcfg, perturb=True))


def test_dense_forward_slots_matches_jax():
    """The dense per-slot forward (the engine's page_size=0 decode): per-row writes,
    including a row whose T=3 write runs past the cache end (dropped)."""
    jcfg, tcfg = _configs()
    jparams, tparams = _params(jcfg, tcfg)
    B, max_len = 2, 16
    jcache = jl.init_cache(jcfg, B, max_len)
    tcache = tl.init_cache(tcfg, B, max_len, device="cpu")
    rng = np.random.default_rng(6)
    pos = np.array([2, 11], np.int32)
    for T in (3, 1, 3):
        toks = rng.integers(1, jcfg.vocab_size, (B, T)).astype(np.int32)
        jlog, jcache = jl.forward_slots(jparams, jnp.asarray(toks), jcache,
                                        jnp.asarray(pos), jcfg)
        tlog, tcache = tl.forward_slots(tparams, torch.from_numpy(toks), tcache,
                                        torch.from_numpy(pos), tcfg)
        # Row 1's last call writes slots 15..17 of a 16-slot cache: only slot 15 lands.
        _close(tlog, jlog)
        pos = pos + T
    np.testing.assert_array_equal(tcache["valid"].numpy(), np.asarray(jcache["valid"]))
    for tk, jk in zip(tcache["layers"], jcache["layers"]):
        _close(tk["k"], jk["k"])


def test_params_from_jax_layout():
    """Stacked params unstack to a per-layer list; projections and the embedding
    land in cfg.dtype, norm gammas in fp32."""
    jcfg, _ = _configs(scan_layers=True)
    tcfg = dataclasses.replace(tl.CONFIGS["tiny"], dtype=torch.bfloat16, scan_layers=True)
    np_params = jax.tree.map(np.asarray, jl.init_params(jcfg))
    tparams = params_from_jax(np_params, tcfg, device="cpu")
    assert len(tparams["layers"]) == jcfg.n_layers
    assert tparams["embed"].dtype == torch.bfloat16
    assert tparams["lm_head"].dtype == torch.bfloat16
    assert tparams["layers"][1]["wq"].dtype == torch.bfloat16
    assert tparams["layers"][1]["ln_attn"].dtype == torch.float32
    np.testing.assert_array_equal(
        tparams["layers"][1]["w_up"].float().numpy(),
        np.asarray(jnp.asarray(np_params["layers"]["w_up"][1]).astype(jnp.bfloat16)
                   .astype(jnp.float32)))
