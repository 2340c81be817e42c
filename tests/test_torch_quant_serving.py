"""The int8 weight-only serving slice against the JAX package, on the CPU at fp32.

The ``tiny`` config's JAX params are quantized by the JAX ``load_and_quantize_model``
(``skip_modules=["embed", "lm_head"]``, ``min_weight_size=1``: every projection of every
layer) and carried across by ``convert.params_from_jax``, codes and scales unchanged.
On both sides each projection then runs through ``quant_matmul`` — JAX's Pallas kernel
in interpret mode, the port's plain version of its kernel. Compared: ``forward_cached``
logits (rtol = atol = 1e-5, the two frameworks' fp32 sums round differently in the last
bits) and the ``ContinuousBatcher`` greedy tokens, token for token, dense and paged
(``page_size=8``); nf4 leaves (dequantize, then multiply) as well. A quantized
embedding or head raises ``NotImplementedError``, and so does training over quantized
leaves (QLoRA is not ported).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from accelerate_tpu.models import llama as jl
from accelerate_tpu.ops import quantization as jq
from accelerate_tpu.serving import ContinuousBatcher as JaxBatcher
from accelerate_tpu_torch import optim
from accelerate_tpu_torch.accelerator import Accelerator
from accelerate_tpu_torch.models import llama as tl
from accelerate_tpu_torch.models.convert import params_from_jax
from accelerate_tpu_torch.ops import quantization as tq
from accelerate_tpu_torch.serving import ContinuousBatcher
from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState

ENGINE = dict(max_slots=2, max_len=64, prompt_bucket=16)
SKIP = ["embed", "lm_head"]


def _cfgs():
    return (dataclasses.replace(jl.CONFIGS["tiny"], dtype=jnp.float32),
            dataclasses.replace(tl.CONFIGS["tiny"], dtype=torch.float32))


def _quantized(scheme="int8", skip=SKIP):
    jcfg, tcfg = _cfgs()
    kw = (dict(load_in_8bit=True) if scheme == "int8"
          else dict(load_in_4bit=True, bnb_4bit_quant_type=scheme))
    jparams = jq.load_and_quantize_model(
        jl.init_params(jcfg, jax.random.PRNGKey(3)),
        jq.BnbQuantizationConfig(skip_modules=skip, min_weight_size=1, **kw))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    return jcfg, tcfg, jparams, tparams


@pytest.fixture(scope="module")
def int8_setup():
    return _quantized("int8")


def test_every_projection_is_int8(int8_setup):
    *_, tparams = int8_setup
    for layer in tparams["layers"]:
        for name in tl.PROJECTIONS:
            w = layer[name]
            assert isinstance(w, tq.QuantizedWeight) and w.scheme == "int8"
            assert w.data.dtype == torch.int8 and w.scales.dtype == torch.float32
        assert torch.is_tensor(layer["ln_attn"])
    assert torch.is_tensor(tparams["embed"]) and torch.is_tensor(tparams["lm_head"])


def test_forward_cached_matches_jax(int8_setup):
    jcfg, tcfg, jparams, tparams = int8_setup
    rng = np.random.default_rng(0)
    tokens = rng.integers(1, jcfg.vocab_size, (2, 12)).astype(np.int32)
    mask = np.ones((2, 12), bool)
    mask[1, :5] = False  # row 1 left-padded by 5
    jlog, _ = jl.forward_cached(jparams, jnp.asarray(tokens), jl.init_cache(jcfg, 2, 32), jcfg,
                                token_mask=jnp.asarray(mask))
    before = tq.int8_matmul.launches
    tlog, _ = tl.forward_cached(tparams, torch.from_numpy(tokens),
                                tl.init_cache(tcfg, 2, 32, device="cpu"), tcfg,
                                token_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=1e-5, atol=1e-5)
    assert tq.int8_matmul.launches == before  # CPU calls take the plain version


def _drive(engine, prompts, budgets):
    reqs = [engine.submit(p, max_new_tokens=n) for p, n in zip(prompts, budgets)]
    engine.run()
    return [list(map(int, r.tokens)) for r in reqs]


def _prompts():
    rng = np.random.default_rng(0)
    return [rng.integers(1, 256, int(n)).astype(np.int32) for n in (5, 9, 20, 7, 6)]


@pytest.mark.parametrize("page_size", [0, 8], ids=["dense", "paged"])
def test_int8_engine_matches_jax(int8_setup, page_size):
    jcfg, tcfg, jparams, tparams = int8_setup
    prompts, budgets = _prompts(), (6, 4, 8, 3, 5)
    want = _drive(JaxBatcher(jparams, jcfg, page_size=page_size, **ENGINE), prompts, budgets)
    eng = ContinuousBatcher(tparams, tcfg, page_size=page_size, **ENGINE)
    assert _drive(eng, prompts, budgets) == want
    s = eng.stats()
    assert s["admitted"] == s["evicted"] == len(prompts)
    if page_size:
        assert s["pages_in_use"] == 0


def test_nf4_engine_matches_jax():
    jcfg, tcfg, jparams, tparams = _quantized("nf4")
    assert tparams["layers"][0]["wq"].scheme == "nf4"
    prompts, budgets = _prompts()[:3], (5, 4, 6)
    want = _drive(JaxBatcher(jparams, jcfg, page_size=8, **ENGINE), prompts, budgets)
    assert _drive(ContinuousBatcher(tparams, tcfg, page_size=8, **ENGINE), prompts,
                  budgets) == want


@pytest.mark.parametrize("leaf", ["embed", "lm_head"])
def test_quantized_embed_or_head_raises(leaf):
    """A quantized embedding or head cannot run (neither can it in the JAX forwards):
    the port says so plainly."""
    skip = [name for name in SKIP if name != leaf]
    *_, tparams = _quantized("int8", skip=skip)
    assert isinstance(tparams[leaf], tq.QuantizedWeight)
    eng = ContinuousBatcher(tparams, _cfgs()[1], **ENGINE)
    eng.submit(np.arange(1, 6, dtype=np.int32), max_new_tokens=2)
    with pytest.raises(NotImplementedError, match=f"quantized '{leaf}'"):
        eng.run()


def test_training_over_quantized_leaves_raises(int8_setup):
    *_, tcfg, _, tparams = int8_setup
    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()
    try:
        acc = Accelerator(device="cpu")
        with pytest.raises(NotImplementedError, match="QLoRA"):
            acc.create_train_state(tparams, optim.adamw(1e-3))
        dense = jax.tree.map(np.asarray, jl.init_params(_cfgs()[0]))
        state = acc.create_train_state(params_from_jax(dense, tcfg, device="cpu"),
                                       optim.adamw(1e-3))
        step = acc.build_train_step(lambda p, b: tl.loss_fn(p, b, tcfg))
        state.params["layers"][0]["wq"] = tparams["layers"][0]["wq"]
        with pytest.raises(NotImplementedError, match="QLoRA"):
            step(state, {"tokens": np.ones((1, 9), np.int64)})
    finally:
        for cls in (AcceleratorState, GradientState, PartialState):
            cls._reset_state()
