"""The port's fp8 ops and fp8 training against the JAX package's, on the CPU.

Mirrors ``tests/test_fp8.py`` (its two slow tests at the ``tiny`` width in 3 steps) and
adds the cross-package checks:

- ``quantize``: the fp8 codes bit for bit, both formats, over 200,000 values spread
  over many magnitudes, saturating ones included; ``compute_scale`` bit for bit.
- ``fp8_dot`` and its gradients against JAX's ``custom_vjp``, current and delayed
  scales, both formats: within 1e-5 of the largest magnitude (the same fp8 codes, fp32
  sums taken in another order).
- ``delayed_scales`` and ``DelayedScalingState.update`` against JAX's, bit for bit.
- A delayed-scaling train step (``tiny``, fp32 compute, ``use_fp8``) against the JAX
  ``build_train_step``: losses rtol 1e-5 and the amax history rtol 1e-6 (an operand a
  rounding apart may quantize to a neighbouring code, which moves a loss by far less);
  with ``remat=True`` against ``remat=False``, bit for bit (the delayed-scaling
  context stays open across the recomputing backward).
- ``use_fp8`` on the cached paths (``generate``, the paged engine, its super-step):
  JAX's greedy tokens.
- ``ScaledAdamState`` (``fused_adamw(mu_dtype=float8_e4m3fn, nu_dtype=float8_e4m3fn)``)
  against JAX's, update for update: the fp8 moment codes equal on 99.9% of elements and
  within one code elsewhere, scales and params rtol 1e-6 (fp32 expressions in one order;
  XLA may contract a multiply-add).
- A delayed-scaling O2 state saved and resumed: the next steps bit for bit.
"""

import dataclasses
import functools
import logging

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from accelerate_tpu import accelerator as jacc
from accelerate_tpu.models import llama as jl
from accelerate_tpu.ops import fp8 as jf
from accelerate_tpu.ops import fused_optim as jfo
from accelerate_tpu.utils.dataclasses import FP8RecipeKwargs as JaxRecipe
from accelerate_tpu_torch import accelerator as tacc
from accelerate_tpu_torch import optim as topt
from accelerate_tpu_torch.models import llama as tl
from accelerate_tpu_torch.models.convert import params_from_jax
from accelerate_tpu_torch.ops import fp8 as tf
from accelerate_tpu_torch.ops import fused_optim as tfo
from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState
from accelerate_tpu_torch.utils.dataclasses import FP8RecipeKwargs
from accelerate_tpu_torch.utils.tree import tree_leaves

FORMATS = {"e4m3": (jnp.float8_e4m3fn, torch.float8_e4m3fn),
           "e5m2": (jnp.float8_e5m2, torch.float8_e5m2)}


@pytest.fixture(autouse=True)
def _reset_port_singletons():
    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()
    tf.set_default_recipe("HYBRID", 0)
    yield
    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()
    tf.set_default_recipe("HYBRID", 0)
    jf.set_default_recipe("HYBRID", 0)


def _np(x):
    return np.asarray(x.detach() if torch.is_tensor(x) else x)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


# ------------------------------------------------------------------------------- scaling
def test_compute_scale_power_of_two():
    """The port's scales are exact powers of two. XLA's CPU ``exp2`` rounds 2^e for most
    |e| > 12 (2^31 comes out 2147482750): there JAX's scale is within 1e-6 of the
    port's, whose exponent is the same."""
    assert float(tf.compute_scale(torch.tensor(1.0), torch.float8_e4m3fn)) == 256.0
    assert float(tf.compute_scale(torch.tensor(1.0), torch.float8_e4m3fn, margin=2)) == 64.0
    amax = np.abs(np.random.default_rng(0).standard_normal(2000)
                  * 10.0 ** np.linspace(-6, 6, 2000)).astype(np.float32)
    for (jdt, tdt) in FORMATS.values():
        for margin in (0, 3):
            want = np.asarray(jf.compute_scale(jnp.asarray(amax), jdt, margin))
            got = _np(tf.compute_scale(torch.tensor(amax), tdt, margin))
            exact = np.exp2(np.round(np.log2(want.astype(np.float64)))).astype(np.float32)
            assert np.array_equal(got, exact)
            assert np.abs(want / got - 1).max() < 4e-6
            small = np.abs(np.log2(exact)) <= 12  # where XLA's exp2 is exact
            assert small.sum() > 500 and np.array_equal(got[small], want[small])


@pytest.mark.parametrize("fmt", list(FORMATS))
def test_quantize_bitwise_against_jax(fmt):
    jdt, tdt = FORMATS[fmt]
    rng = np.random.default_rng(1)
    x = (rng.standard_normal(200_000) * 10.0 ** rng.uniform(-8, 6, 200_000)).astype(np.float32)
    x[:8] = [0.0, -0.0, 1e30, -1e30, 448.0, 464.0, 57344.0, 61440.0]
    for scale in (1.0, 2.0 ** -7, 2.0 ** 9):
        want = np.asarray(jf.quantize(jnp.asarray(x), jnp.float32(scale), jdt)).view(np.uint8)
        got = tf.quantize(torch.from_numpy(x), torch.tensor(scale), tdt).view(torch.uint8)
        assert np.array_equal(got.numpy(), want), fmt


def test_quantize_dequantize_roundtrip():
    x = torch.linspace(-3, 3, 64)
    scale = tf.compute_scale(x.abs().max(), torch.float8_e4m3fn)
    q = tf.quantize(x, scale, torch.float8_e4m3fn)
    assert q.dtype == torch.float8_e4m3fn
    np.testing.assert_allclose(_np(tf.dequantize(q, scale)), _np(x), rtol=0.07, atol=0.05)


def test_quantize_saturates():
    q = tf.quantize(torch.tensor([1e9, -1e9]), torch.tensor(1.0), torch.float8_e4m3fn)
    assert float(q.float().abs().max()) <= tf.FP8_MAX[torch.float8_e4m3fn]


# ------------------------------------------------------------------------------ fp8_dot
def test_fp8_dot_close_to_fp32():
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.normal(size=(8, 32)), dtype=torch.float32)
    w = torch.tensor(rng.normal(size=(32, 16)) * 0.1, dtype=torch.float32)
    assert _rel(_np(tf.fp8_dot(x, w)), _np(x @ w)) < 0.1


def test_fp8_dot_batched_input():
    rng = np.random.default_rng(1)
    x = torch.tensor(rng.normal(size=(2, 5, 16)), dtype=torch.float32)
    w = torch.tensor(rng.normal(size=(16, 8)), dtype=torch.float32)
    assert tf.fp8_dot(x, w).shape == (2, 5, 8)


def _dot_and_grads_jax(x, w, g, fmt, scales):
    def f(x_, w_):
        return jf.fp8_dot(x_, w_, fmt, scales=None if scales is None else jnp.asarray(scales))

    y, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(w))
    dx, dw = vjp(jnp.asarray(g))
    return [np.asarray(a) for a in (y, dx, dw)]


def _dot_and_grads_port(x, w, g, fmt, scales):
    xt = torch.tensor(x, requires_grad=True)
    wt = torch.tensor(w, requires_grad=True)
    y = tf.fp8_dot(xt, wt, fmt, scales=None if scales is None else torch.tensor(scales))
    y.backward(torch.tensor(g))
    return [_np(y), _np(xt.grad), _np(wt.grad)]


@pytest.mark.parametrize("fmt", ["HYBRID", "E4M3"])
@pytest.mark.parametrize("scaling", ["current", "delayed"])
def test_fp8_dot_and_grads_match_jax(fmt, scaling):
    rng = np.random.default_rng(2)

    def with_amax(a, amax):  # amaxes whose scales XLA's exp2 computes exactly
        return (a * (amax / np.abs(a).max())).astype(np.float32)

    x = with_amax(rng.normal(size=(3, 24, 48)), 3.0)
    w = with_amax(rng.normal(size=(48, 40)), 0.8)
    g = with_amax(rng.normal(size=(3, 24, 40)), 3.0)
    # Delayed: scales from a history a little off the tensors' own amaxes (grad: NaN).
    scales = None if scaling == "current" else np.array([2.0 ** 5, 2.0 ** 9, np.nan],
                                                          np.float32)
    want = _dot_and_grads_jax(x, w, g, fmt, scales)
    got = _dot_and_grads_port(x, w, g, fmt, scales)
    for name, a, b in zip(("y", "dx", "dw"), got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert _rel(a, b) <= 1e-5, (name, _rel(a, b))


def test_fp8_dot_grads_match_fp32():
    rng = np.random.default_rng(2)
    x = torch.tensor(rng.normal(size=(4, 16)), dtype=torch.float32)
    w0 = torch.tensor(rng.normal(size=(16, 8)) * 0.2, dtype=torch.float32)
    w8, w32 = w0.clone().requires_grad_(), w0.clone().requires_grad_()
    (tf.fp8_dot(x, w8) ** 2).sum().backward()
    ((x @ w32) ** 2).sum().backward()
    g8, g32 = w8.grad, w32.grad
    assert torch.isfinite(g8).all()
    assert float((g8 * g32).sum() / (g8.norm() * g32.norm())) > 0.98


def test_fp8_dot_e4m3_format():
    out = tf.fp8_dot(torch.ones((4, 8)), torch.ones((8, 4)), tf.Format.E4M3)
    np.testing.assert_allclose(_np(out), 8.0, rtol=0.05)


def test_fp8_linear_bias():
    x, w, b = torch.ones((2, 4)), torch.eye(4), torch.arange(4, dtype=torch.float32)
    np.testing.assert_allclose(_np(tf.fp8_linear(x, w, b)), _np(x + b), rtol=0.05, atol=0.02)


def test_default_recipe_format_is_used():
    x = torch.tensor(np.random.default_rng(3).normal(size=(4, 8)), dtype=torch.float32)
    w = torch.tensor(np.random.default_rng(4).normal(size=(8, 4)), dtype=torch.float32)
    tf.set_default_recipe("E4M3", 1)
    assert torch.equal(tf.fp8_dot(x, w), tf.fp8_dot(x, w, "E4M3", 1))
    with pytest.raises(ValueError, match="unknown fp8 format"):
        tf.fp8_dot(x, w, "E5M2")


def _exact_pow2(scales):
    return np.exp2(np.round(np.log2(scales.astype(np.float64)))).astype(np.float32)


def _jax_exact_scale(amax, fp8_dtype, margin=0):
    """JAX's ``compute_scale`` with its power of two made exact (``ldexp``): XLA's CPU
    ``exp2`` rounds 2^e for most |e| > 12, which moves JAX's e5m2 gradient codes off the
    port's exact ones (``test_compute_scale_power_of_two`` holds that deviation)."""
    amax = jnp.maximum(amax.astype(jnp.float32), 1e-12)
    exp = jnp.floor(jnp.log2(jf.FP8_MAX[fp8_dtype] / amax)) - margin
    return jnp.ldexp(jnp.float32(1.0), exp.astype(jnp.int32))


# ----------------------------------------------------------------------- delayed scaling
def test_delayed_scaling_state_update_and_scales():
    state = tf.DelayedScalingState.init(amax_history_len=4)
    assert torch.isnan(tf.delayed_scales(state)).all(), "empty history means current scaling"
    state = state.update(1.0, 2.0, 4.0)
    state = state.update(0.5, 1.0, 2.0)
    assert int(state.step) == 2
    scales = tf.delayed_scales(state)
    assert float(scales[0]) == 256.0 and float(scales[1]) == 128.0
    assert float(scales[2]) == float(tf.compute_scale(torch.tensor(4.0), torch.float8_e5m2))
    assert float(tf.delayed_scales(state, amax_compute_algo="most_recent")[0]) == 512.0


def test_delayed_scales_match_jax():
    rng = np.random.default_rng(5)
    amaxes = (np.abs(rng.standard_normal((7, 3))) * 10.0 ** rng.uniform(-3, 3, (7, 3)))
    amaxes[2, 1] = 0.0
    jstate, tstate = jf.DelayedScalingState.init(4), tf.DelayedScalingState.init(4)
    for row in amaxes.astype(np.float32):
        jstate = jstate.update(*(jnp.float32(v) for v in row))
        tstate = tstate.update(*(torch.tensor(v) for v in row))
        assert np.array_equal(_np(tstate.history), np.asarray(jstate.history))
        assert int(tstate.step) == int(jstate.step)
        for fmt in ("HYBRID", "E4M3"):
            for algo in ("max", "most_recent"):
                for margin in (0, 2):
                    want = np.asarray(jf.delayed_scales(jstate, fmt, margin, algo))
                    got = _np(tf.delayed_scales(tstate, fmt, margin, algo))
                    assert np.array_equal(np.isnan(got), np.isnan(want))
                    ok = ~np.isnan(want)  # JAX's scales a few ulp off 2^e (see above)
                    assert np.array_equal(got[ok], _exact_pow2(want[ok])), (fmt, algo)
                    assert np.abs(want[ok] / got[ok] - 1).max() < 4e-6
    with pytest.raises(ValueError, match="amax_compute_algo"):
        tf.delayed_scales(tstate, amax_compute_algo="median")


def test_delayed_scales_feed_fp8_dot():
    rng = np.random.default_rng(3)
    x = torch.tensor(rng.normal(size=(4, 8)), dtype=torch.float32)
    w = torch.tensor(rng.normal(size=(8, 4)), dtype=torch.float32)
    state = tf.DelayedScalingState.init(4).update(x.abs().max(), w.abs().max(), 1.0)
    got = tf.fp8_dot(x, w, scales=tf.delayed_scales(state))
    np.testing.assert_allclose(_np(got), _np(x @ w), rtol=0.15, atol=0.1)


def test_delayed_scaling_state_is_a_tree():
    assert len(tree_leaves(tf.DelayedScalingState.init(4))) == 2  # history + step


def test_autoscale_ctx_collects_forward_amaxes():
    x, w = torch.full((2, 4), 3.0), torch.full((4, 2), 0.5)
    scales = torch.tensor([float("nan")] * 3)
    with tf.autoscale_ctx(scales) as ctx:
        tf.fp8_dot(x, w)
        tf.fp8_dot(x * 0.1, w * 4)
        assert ctx["amax"].tolist() == [3.0, 2.0]
    assert tf._AUTOSCALE["scales"] is None


# ------------------------------------------------------------------------------- recipe
def test_fp8_recipe_kwargs_validation():
    assert FP8RecipeKwargs(fp8_format="hybrid").fp8_format == "HYBRID"
    with pytest.raises(ValueError):
        FP8RecipeKwargs(fp8_format="E5M2")
    with pytest.raises(ValueError):
        FP8RecipeKwargs(amax_compute_algo="median")
    assert dataclasses.asdict(FP8RecipeKwargs()) == dataclasses.asdict(JaxRecipe())


def test_accelerator_fp8_sets_recipe():
    acc = tacc.Accelerator(mixed_precision="fp8", device="cpu")
    assert acc.fp8_recipe is not None and acc.mixed_precision == "fp8"
    assert acc.mixed_precision_policy.compute_dtype == torch.bfloat16


def test_accelerator_fp8_recipe_handler_override():
    recipe = FP8RecipeKwargs(margin=2, use_delayed_scaling=True, fp8_format="E4M3")
    acc = tacc.Accelerator(mixed_precision="fp8", kwargs_handlers=[recipe], device="cpu")
    assert acc.fp8_recipe.margin == 2 and acc.fp8_recipe.use_delayed_scaling
    assert tf._resolve(None, None) == ("E4M3", 2)
    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()
    with pytest.raises(NotImplementedError, match="kwargs handler"):
        tacc.Accelerator(kwargs_handlers=[topt.EmptyState()], device="cpu")


def test_fp8_opt_level_validation(monkeypatch):
    monkeypatch.delenv("ACCELERATE_FP8_OPT_LEVEL", raising=False)
    assert FP8RecipeKwargs().opt_level == "O1"
    assert FP8RecipeKwargs(opt_level="o2").opt_level == "O2"
    with pytest.raises(ValueError):
        FP8RecipeKwargs(opt_level="O3")
    monkeypatch.setenv("ACCELERATE_FP8_OPT_LEVEL", "O2")
    assert FP8RecipeKwargs().opt_level == "O2"


def test_fp8_opt_level_o2_upgrades_fused_adamw(monkeypatch, caplog):
    monkeypatch.delenv("ACCELERATE_FP8_OPT_LEVEL", raising=False)
    acc = tacc.Accelerator(mixed_precision="fp8", kwargs_handlers=[FP8RecipeKwargs(opt_level="O2")],
                           device="cpu")
    wrapped = acc.prepare_optimizer(tfo.fused_adamw(1e-3))
    assert wrapped.optimizer.mu_dtype == wrapped.optimizer.nu_dtype == torch.float8_e4m3fn
    assert isinstance(wrapped.init({"w": torch.zeros((8, 1024))}), tfo.ScaledAdamState)
    explicit = acc.prepare_optimizer(tfo.fused_adamw(1e-3, mu_dtype=torch.bfloat16))
    assert explicit.optimizer.mu_dtype == torch.bfloat16 and explicit.optimizer.nu_dtype is None
    with caplog.at_level(logging.WARNING):
        plain = acc.prepare_optimizer(topt.adamw(1e-3))
    assert "keeps fp32 optimizer state" in caplog.text
    assert not isinstance(plain.init({"w": torch.zeros(8)}), tfo.ScaledAdamState)
    assert acc.prepare_optimizer(wrapped).optimizer.mu_dtype == torch.float8_e4m3fn
    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()
    acc_o1 = tacc.Accelerator(mixed_precision="fp8", device="cpu")
    assert acc_o1.prepare_optimizer(tfo.fused_adamw(1e-3)).optimizer.mu_dtype is None


def test_delayed_scaling_state_not_created_without_flag():
    acc = tacc.Accelerator(mixed_precision="fp8", device="cpu")
    assert acc.create_train_state({"w": torch.ones((8, 8))}, topt.sgd(0.1)).fp8_state is None


# ---------------------------------------------------------------------- llama end-to-end
STEPS = 3
TOKENS = np.random.default_rng(0).integers(0, 256, (8, 17)).astype(np.int32)


def _cfgs(**kw):
    base = {"attn_impl": "xla", "use_fp8": True, **kw}
    return (dataclasses.replace(jl.CONFIGS["tiny"], dtype=jnp.float32, **base),
            dataclasses.replace(tl.CONFIGS["tiny"], dtype=torch.float32, **base))


def _np_params(jcfg):
    return jax.tree.map(np.asarray, jl.init_params(jcfg, jax.random.PRNGKey(0)))


@functools.lru_cache(maxsize=None)
def _jax_delayed_run():
    """3 steps of the JAX step with delayed scaling (fp32 compute, adam): losses and the
    amax history after each step."""
    from accelerate_tpu.state import AcceleratorState as JS, GradientState as JG, \
        PartialState as JP

    for cls in (JS, JG, JP):
        cls._reset_state()
    exp2_scale, jf.compute_scale = jf.compute_scale, _jax_exact_scale
    try:
        jcfg, _ = _cfgs()
        acc = jacc.Accelerator(kwargs_handlers=[JaxRecipe(use_delayed_scaling=True,
                                                          amax_history_len=4)])
        state = acc.create_train_state(jax.tree.map(jnp.asarray, _np_params(jcfg)),
                                       optax.adam(1e-2))
        step = acc.build_train_step(lambda p, b: jl.loss_fn(p, b, jcfg))
        out = {"losses": [], "history": []}
        for _ in range(STEPS):
            state, m = step(state, {"tokens": jnp.asarray(TOKENS)})
            out["losses"].append(float(m["loss"]))
            out["history"].append(np.asarray(state.fp8_state.history))
        return out
    finally:
        jf.compute_scale = exp2_scale
        for cls in (JS, JG, JP):
            cls._reset_state()
        jf.set_default_recipe("HYBRID", 0)


def _port_run(remat=False, opt=None, steps=STEPS, **recipe):
    jcfg, tcfg = _cfgs(remat=remat)
    acc = tacc.Accelerator(device="cpu", kwargs_handlers=[FP8RecipeKwargs(
        use_delayed_scaling=True, amax_history_len=4, **recipe)])
    params = params_from_jax(_np_params(jcfg), tcfg, device="cpu")
    state = acc.create_train_state(params, opt or topt.adamw(1e-2, weight_decay=0.0))
    step = acc.build_train_step(lambda p, b: tl.loss_fn(p, b, tcfg))
    out = {"losses": [], "history": []}
    for _ in range(steps):
        state, m = step(state, {"tokens": TOKENS})
        out["losses"].append(float(m["loss"]))
        out["history"].append(_np(state.fp8_state.history).copy())
    return acc, state, step, out


def test_llama_fp8_forward_and_training_step():
    jcfg, tcfg = _cfgs()
    np_params = _np_params(jcfg)
    tokens = TOKENS[:2, :-1]
    want = np.asarray(jl.forward(jax.tree.map(jnp.asarray, np_params), jnp.asarray(tokens),
                                 jcfg, shard_activations=False))
    got = _np(tl.forward(params_from_jax(np_params, tcfg, device="cpu"),
                         torch.as_tensor(tokens), tcfg))
    assert np.isfinite(got).all()
    assert _rel(got, want) <= 1e-4
    acc = tacc.Accelerator(mixed_precision="fp8", device="cpu")
    state = acc.create_train_state(params_from_jax(np_params, tcfg, device="cpu"),
                                   topt.adamw(1e-2))
    step = acc.build_train_step(lambda p, b: tl.loss_fn(p, b, tcfg))
    losses = []
    for _ in range(STEPS):
        state, metrics = step(state, {"tokens": TOKENS})
        losses.append(float(metrics["loss"]))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses


def test_fp8_decode_paths_match_jax():
    """``use_fp8`` on the cached paths: ``generate``, the paged engine and its 4-step
    super-step give JAX's greedy tokens."""
    from accelerate_tpu.generation import GenerationConfig as JaxGen
    from accelerate_tpu_torch.generation import GenerationConfig
    from accelerate_tpu_torch.serving import ContinuousBatcher

    jcfg, tcfg = _cfgs()
    np_params = _np_params(jcfg)
    prompt = np.array([[3, 5, 7, 9, 11, 2]], np.int32)
    want = np.asarray(jl.generate(jax.tree.map(jnp.asarray, np_params), jnp.asarray(prompt),
                                  jcfg, gen=JaxGen(max_new_tokens=8)))
    params = params_from_jax(np_params, tcfg, device="cpu")
    got = tl.generate(params, torch.as_tensor(prompt), tcfg, gen=GenerationConfig(max_new_tokens=8))
    assert np.array_equal(got.numpy(), want)
    for n in (1, 4):
        eng = ContinuousBatcher(params, tcfg, max_slots=2, max_len=128, page_size=8,
                                prompt_bucket=16, decode_steps=n)
        req = eng.submit(prompt[0], max_new_tokens=8)
        eng.run()
        assert req.tokens == want[0].tolist(), n


def test_delayed_scaling_auto_threaded_matches_jax():
    want = _jax_delayed_run()
    _, state, _, got = _port_run(opt=topt.adamw(1e-2, weight_decay=0.0))
    assert int(state.fp8_state.step) == STEPS
    hist = got["history"][-1]
    assert (hist[:2, :STEPS] > 0).all() and (hist[2] == 0).all()
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    for g, w in zip(got["history"], want["history"]):
        np.testing.assert_allclose(g, w, rtol=1e-6)


def test_fp8_step_under_remat_is_bitwise_the_same():
    _, s_plain, _, plain = _port_run(remat=False)
    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()
    _, s_remat, _, remat = _port_run(remat=True)
    assert plain["losses"] == remat["losses"]
    assert all(np.array_equal(a, b) for a, b in zip(plain["history"], remat["history"]))
    for a, b in zip(tree_leaves(s_plain.params), tree_leaves(s_remat.params)):
        assert torch.equal(a, b)


def test_skipped_step_keeps_the_fp8_history():
    acc, state, step, _ = _port_run(steps=1)
    before = state.fp8_state
    guarded = acc.build_train_step(lambda p, b: tl.loss_fn(p, b, _cfgs()[1]) * float("nan"),
                                   skip_nonfinite_steps=2)
    state, metrics = guarded(state, {"tokens": TOKENS})
    assert metrics["nonfinite"]
    assert state.fp8_state is before


# --------------------------------------------------------- scaled-fp8 AdamW moments (O2)
def _adam_inputs(seed=0):
    rng = np.random.default_rng(seed)
    shapes = {"a": (8, 1024), "b": (7, 5), "c": (3,)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.standard_normal(s) * 10.0 ** rng.uniform(-3, 0)).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]
    return params, grads


@pytest.mark.parametrize("path", ["update", "fused_apply"])
def test_scaled_adam_moments_match_jax(path):
    params, grads = _adam_inputs()
    kw = dict(mu_dtype=jnp.float8_e4m3fn, nu_dtype=jnp.float8_e4m3fn)
    jopt = jfo.fused_adamw(1e-2, **kw)
    topt_ = tfo.fused_adamw(1e-2, mu_dtype=torch.float8_e4m3fn, nu_dtype=torch.float8_e4m3fn)
    jp = jax.tree.map(jnp.asarray, params)
    tp = {k: torch.tensor(v) for k, v in params.items()}
    js, ts = jopt.init(jp), topt_.init(tp)
    assert isinstance(js, jfo.ScaledAdamState) and isinstance(ts, tfo.ScaledAdamState)
    for g in grads:
        jg = jax.tree.map(jnp.asarray, g)
        tg = {k: torch.tensor(v) for k, v in g.items()}
        if path == "update":
            ju, js = jopt.update(jg, js, jp)
            jp = optax.apply_updates(jp, ju)
            tu, ts = topt_.update(tg, ts, tp)
            tp = topt.apply_updates(tp, tu)
        else:
            jp, js = jopt.fused_apply(jg, js, jp, grad_scale=0.5)
            tp, ts = topt_.fused_apply(tg, ts, tp, grad_scale=0.5)
        assert ts.count == int(js.count)
        for k in params:
            for field in ("mu", "nu"):
                got = getattr(ts, field)[k].view(torch.uint8).numpy().astype(np.int16)
                want = np.asarray(getattr(js, field)[k]).view(np.uint8).astype(np.int16)
                assert np.mean(got == want) >= 0.999 and np.abs(got - want).max() <= 1
                np.testing.assert_allclose(float(getattr(ts, field + "_scale")[k]),
                                           float(getattr(js, field + "_scale")[k]), rtol=1e-6)
            np.testing.assert_allclose(_np(tp[k]), np.asarray(jp[k]), rtol=1e-6, atol=1e-7)


def test_o2_state_resumes_bitwise(tmp_path):
    recipe = dict(opt_level="O2")
    acc, state, step, _ = _port_run(opt=None, steps=2, **recipe)
    assert isinstance(state.opt_state, topt.AdamState)  # adamw is not fused: stays fp32
    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()
    jcfg, tcfg = _cfgs()
    acc = tacc.Accelerator(device="cpu", kwargs_handlers=[FP8RecipeKwargs(
        use_delayed_scaling=True, amax_history_len=4, **recipe)])
    state = acc.create_train_state(params_from_jax(_np_params(jcfg), tcfg, device="cpu"),
                                   tfo.fused_adamw(1e-2))
    assert isinstance(state.opt_state, tfo.ScaledAdamState)
    step = acc.build_train_step(lambda p, b: tl.loss_fn(p, b, tcfg))
    for _ in range(2):
        state, _ = step(state, {"tokens": TOKENS})
    acc.save_state(str(tmp_path / "ckpt"), train_state=state)
    def tensors(st):
        return [t for t in tree_leaves([st.params, st.opt_state, st.fp8_state])
                if torch.is_tensor(t)]

    saved = [t.clone() for t in tensors(state)]

    def two_more(st):
        losses = []
        for _ in range(2):
            st, m = step(st, {"tokens": TOKENS})
            losses.append(float(m["loss"]))
        return st, losses

    state, first = two_more(state)
    state = acc.load_state(str(tmp_path / "ckpt"), train_state=state)
    restored = tensors(state)
    assert all(a.dtype == b.dtype and torch.equal(a.reshape(-1).view(torch.uint8),
                                                  b.reshape(-1).view(torch.uint8))
               for a, b in zip(saved, restored))
    assert {str(t.dtype) for t in tree_leaves(state.opt_state.mu)} == {"torch.float8_e4m3fn"}
    state, again = two_more(state)
    assert first == again
    assert int(state.fp8_state.step) == 4
