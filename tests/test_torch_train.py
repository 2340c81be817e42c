"""The port's training path against the JAX package's, on the CPU at fp32.

- ``llama.loss_fn`` value and gradients (torch autograd against ``jax.value_and_grad``)
  on the ``tiny`` config with ``attn_impl="flash"`` (the JAX Pallas kernels in interpret
  mode, the port's plain versions): stacked and unstacked params, packed segment ids,
  an alternating sliding window with a score softcap, a forced loss chunk that does not
  divide S, checkpointed blocks, and the xla attention path.
- Four calls of ``Accelerator.build_train_step`` (gradient accumulation 2, global-norm
  clipping, ``cast_params`` both ways, ``adamw`` and ``fused_adamw``, a value clamp,
  ``loss_impl="fused"``) against the JAX ``build_train_step``; and one bf16 run through
  the ``compress_reduce`` branch.
- ``convert``: JAX → port → numpy round trips, bit-equal in fp32.
- The step's own contracts: the non-finite guard, ``fused_steps``, and what raises.

Tolerances (fp32): loss rtol 1e-5; gradients atol 2e-6 + rtol 1e-4 (sums over a few
hundred products taken in another order). Params after training: 99.9% of the elements
within atol 2e-6 + rtol 1e-5, and every element within lr/2 — AdamW divides by the
root of the second moment, so an element whose gradient is at the level of rounding
noise can move by a fraction of lr on one side and not on the other.
The bf16 run compares losses at rtol 2e-2 (bf16 rounds in other places in XLA and in
torch's CPU kernels).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from accelerate_tpu import accelerator as jacc
from accelerate_tpu.models import llama as jl
from accelerate_tpu.ops import fused_optim as jfo
from accelerate_tpu_torch import accelerator as tacc
from accelerate_tpu_torch import optim as topt
from accelerate_tpu_torch.models import llama as tl
from accelerate_tpu_torch.models.convert import params_from_jax, params_to_numpy
from accelerate_tpu_torch.ops import fused_optim as tfo
from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState

B, S = 2, 24


@pytest.fixture(autouse=True)
def _reset_port_singletons():
    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()
    yield
    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()


def _configs(**kw):
    base = {"dtype": jnp.float32, "attn_impl": "flash", **kw}
    jcfg = dataclasses.replace(jl.CONFIGS["tiny"], **base)
    tcfg = dataclasses.replace(tl.CONFIGS["tiny"], **{**base, "dtype": torch.float32})
    return jcfg, tcfg


def _np_params(jcfg, seed=1):
    return jax.tree.map(np.asarray, jl.init_params(jcfg, jax.random.PRNGKey(seed)))


def _batch(vocab, seed=0, packed=False):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(1, vocab, (B, S + 1)).astype(np.int32)}
    if packed:
        seg = np.zeros((B, S + 1), np.int32)
        seg[0, :10], seg[0, 10:20] = 1, 2   # two sequences and 5 pad slots
        seg[1, :14], seg[1, 14:] = 1, 2
        batch["segment_ids"] = seg
    return batch


def _allclose(got, want, atol, rtol):
    got = jax.tree_util.tree_leaves(got)
    want = jax.tree_util.tree_leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), atol=atol, rtol=rtol)


LOSS_CASES = {
    "unstacked": ({}, {}),
    "stacked": ({"scan_layers": True}, {}),
    "packed_segments": ({}, {"packed": True}),
    "window_alternating_softcap": (
        {"sliding_window": 8, "window_every": 2, "attn_softcap": 20.0}, {}),
    "loss_chunk_padded": ({"loss_chunk": 10}, {}),
    "remat": ({"remat": True}, {"packed": True}),
    "xla_attention": ({"attn_impl": "xla", "sliding_window": 8}, {"packed": True}),
}


@pytest.mark.parametrize("case", list(LOSS_CASES))
def test_loss_and_grads_match_jax(case):
    cfg_kw, batch_kw = LOSS_CASES[case]
    jcfg, tcfg = _configs(**cfg_kw)
    np_params = _np_params(jcfg)
    batch = _batch(jcfg.vocab_size, **batch_kw)

    jloss, jgrads = jax.value_and_grad(jl.loss_fn)(
        jax.tree.map(jnp.asarray, np_params), jax.tree.map(jnp.asarray, batch), jcfg)

    params = params_from_jax(np_params, tcfg, device="cpu", master_dtype=torch.float32)
    leaves = [p.requires_grad_() for p in jax.tree_util.tree_leaves(params)]
    tloss = tl.loss_fn(params, {k: torch.tensor(v) for k, v in batch.items()}, tcfg)
    grads = torch.autograd.grad(tloss, leaves)
    grad_tree = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(params), grads)

    np.testing.assert_allclose(float(tloss.detach()), float(jloss), rtol=1e-5)
    _allclose(params_to_numpy(grad_tree, stacked=jcfg.scan_layers),
              jax.tree.map(np.asarray, jgrads), atol=2e-6, rtol=1e-4)


TRAIN_CASES = {  # optimizer, cast_params, extra build_train_step arguments, config
    "adamw_cast": ("adamw", True, {}, {}),
    "adamw_no_cast": ("adamw", False, {}, {}),
    "fused_adamw_cast_clip_value": ("fused_adamw", True, {"max_grad_value": 2e-3}, {}),
    "fused_ce_fused_adamw": ("fused_adamw", True, {}, {"loss_impl": "fused"}),
}


def _optimizers(name):
    if name == "adamw":
        return optax.adamw(1e-3), topt.adamw(1e-3)
    return jfo.fused_adamw(1e-3), tfo.fused_adamw(1e-3)


@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_train_steps_match_jax(case):
    opt_name, cast_params, extra, cfg_kw = TRAIN_CASES[case]
    jcfg, tcfg = _configs(**cfg_kw)
    np_params = _np_params(jcfg, seed=2)
    batches = [_batch(jcfg.vocab_size, seed=10 + i) for i in range(4)]
    jopt, topt_ = _optimizers(opt_name)

    ja = jacc.Accelerator(gradient_accumulation_steps=2)
    jstate = ja.create_train_state(jax.tree.map(jnp.asarray, np_params), jopt)
    jstep = ja.build_train_step(lambda p, b: jl.loss_fn(p, b, jcfg), max_grad_norm=1.0,
                                cast_params=cast_params, **extra)
    jlosses = []
    for b in batches:
        jstate, m = jstep(jstate, jax.tree.map(jnp.asarray, b))
        jlosses.append(float(m["loss"]))

    ta = tacc.Accelerator(gradient_accumulation_steps=2, device="cpu")
    tstate = ta.create_train_state(params_from_jax(np_params, tcfg, device="cpu",
                                                   master_dtype=torch.float32), topt_)
    tstep = ta.build_train_step(lambda p, b: tl.loss_fn(p, b, tcfg), max_grad_norm=1.0,
                                cast_params=cast_params, **extra)
    tlosses, norms = [], []
    for b in batches:
        tstate, m = tstep(tstate, b)
        tlosses.append(float(m["loss"]))
        norms.append("grad_norm" in m)

    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
    assert norms == [False, True, False, True]  # the apply steps report the norm
    assert tstate.step == int(jstate.step) == 2 and ta.step == 4
    assert ta._optimizers[-1]._step_count == 2
    _params_close(params_to_numpy(tstate.params), jax.tree.map(np.asarray, jstate.params),
                  lr=1e-3)


def _params_close(got, want, lr):
    got = np.concatenate([np.ravel(x) for x in jax.tree_util.tree_leaves(got)])
    want = np.concatenate([np.ravel(x) for x in jax.tree_util.tree_leaves(want)])
    diff = np.abs(got - want)
    assert diff.max() <= lr / 2
    assert np.mean(diff <= 2e-6 + 1e-5 * np.abs(want)) >= 0.999


def test_bf16_compress_reduce_tracks_jax():
    """bf16 compute with fp32 masters: gradients taken w.r.t. the cast tree (the default
    under bf16) on both sides; masters stay fp32."""
    jcfg, tcfg = _configs()
    jcfg = dataclasses.replace(jcfg, dtype=jnp.bfloat16)
    tcfg = dataclasses.replace(tcfg, dtype=torch.bfloat16)
    np_params = _np_params(jcfg, seed=3)
    batches = [_batch(jcfg.vocab_size, seed=20 + i) for i in range(3)]
    ja = jacc.Accelerator(mixed_precision="bf16")
    jstate = ja.create_train_state(jax.tree.map(jnp.asarray, np_params), optax.adamw(1e-3))
    jstep = ja.build_train_step(lambda p, b: jl.loss_fn(p, b, jcfg), max_grad_norm=1.0)
    ta = tacc.Accelerator(mixed_precision="bf16", device="cpu")
    tstate = ta.create_train_state(params_from_jax(np_params, tcfg, device="cpu",
                                                   master_dtype=torch.float32),
                                   topt.adamw(1e-3))
    tstep = ta.build_train_step(lambda p, b: tl.loss_fn(p, b, tcfg), max_grad_norm=1.0)
    assert ta._reduce_compressed and ja._reduce_compressed
    for b in batches:
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, b))
        tstate, tm = tstep(tstate, b)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=2e-2)
    assert all(p.dtype == torch.float32 for p in jax.tree_util.tree_leaves(tstate.params))


@pytest.mark.parametrize("stacked", [False, True])
def test_convert_round_trip_bit_equal(stacked):
    jcfg, tcfg = _configs(scan_layers=stacked)
    np_params = _np_params(jcfg)
    back = params_to_numpy(params_from_jax(np_params, tcfg, device="cpu",
                                           master_dtype=torch.float32), stacked=stacked)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(np_params)
    for got, want in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(np_params)):
        assert got.dtype == np.float32 and np.array_equal(got, want)


def test_master_dtype_keeps_fp32_weights():
    jcfg = dataclasses.replace(jl.CONFIGS["tiny"], dtype=jnp.bfloat16)
    np_params = _np_params(jcfg)
    serving = params_from_jax(np_params, tl.CONFIGS["tiny"], device="cpu")
    training = params_from_jax(np_params, tl.CONFIGS["tiny"], device="cpu",
                               master_dtype=torch.float32)
    assert serving["layers"][0]["wq"].dtype == torch.bfloat16
    assert training["layers"][0]["wq"].dtype == torch.float32
    assert training["embed"].dtype == training["lm_head"].dtype == torch.float32
    assert training["layers"][0]["ln_attn"].dtype == torch.float32


# ------------------------------------------------------------------- the step's contracts
def _quadratic():
    params = {"w": torch.tensor([1.0, -2.0, 3.0])}

    def loss(p, b):
        return ((p["w"] * b["x"]) ** 2).sum()

    return params, loss


def test_nonfinite_guard_skips_then_raises():
    params, loss = _quadratic()
    acc = tacc.Accelerator(device="cpu")
    state = acc.create_train_state(params, topt.sgd(0.1))
    step = acc.build_train_step(loss, skip_nonfinite_steps=2)
    good = {"x": np.ones(3, np.float32)}
    bad = {"x": np.full(3, np.nan, np.float32)}
    state, m = step(state, good)
    assert not m["nonfinite"] and state.step == 1
    before = state.params["w"].clone()
    state, m = step(state, bad)
    assert m["nonfinite"] and state.step == 1 and torch.equal(state.params["w"], before)
    with pytest.raises(tacc.NonFiniteStepError):
        step(state, bad)


def test_has_aux_reports_aux():
    params, loss = _quadratic()
    acc = tacc.Accelerator(device="cpu")
    state = acc.create_train_state(params, topt.sgd(0.1))
    step = acc.build_train_step(lambda p, b: (loss(p, b), {"w0": p["w"][0]}), has_aux=True)
    state, m = step(state, {"x": np.ones(3, np.float32)})
    assert float(m["aux"]["w0"]) == 1.0 and float(m["loss"]) == 14.0
    assert float(state.params["w"][0]) == pytest.approx(1.0 - 0.1 * 2.0)


def test_fused_steps_match_sequential():
    batches = [{"x": np.full(3, 0.1 * (i + 1), np.float32)} for i in range(4)]
    results = []
    for fused in (False, True):
        for cls in (AcceleratorState, GradientState, PartialState):
            cls._reset_state()
        params, loss = _quadratic()
        acc = tacc.Accelerator(gradient_accumulation_steps=2, device="cpu")
        state = acc.create_train_state(params, topt.adamw(0.05))
        if fused:
            state, m = acc.build_train_step(loss, max_grad_norm=1.0, fused_steps=4)(state, batches)
            losses = m["loss"].tolist()
            assert m["grad_norm"].shape == (4,)
        else:
            step = acc.build_train_step(loss, max_grad_norm=1.0)
            losses = []
            for b in batches:
                state, m = step(state, b)
                losses.append(float(m["loss"]))
        results.append((losses, state.params["w"].clone(), state.step))
    assert results[0][0] == pytest.approx(results[1][0], rel=1e-6)
    assert torch.equal(results[0][1], results[1][1]) and results[0][2] == results[1][2] == 2


def test_unported_options_raise():
    with pytest.raises(NotImplementedError):  # tp_plugin is ported (slice 22); pp is not
        tacc.Accelerator(pp_plugin=object(), device="cpu")
    from accelerate_tpu_torch.models import common

    with pytest.raises(NotImplementedError):
        common.remat_wrap(lambda x: x, remat=True, policy="dots")
    q = torch.zeros((1, 4, 2, 32))
    with pytest.raises(NotImplementedError):
        common.attention_dispatch(q, q, q, None, impl="ring", sm_scale=1.0)
    for impl in ("fused_dp", "fused_tp"):  # both need a mesh context, as in JAX
        jcfg, tcfg = _configs(loss_impl=impl)
        params = params_from_jax(_np_params(jcfg), tcfg, device="cpu")
        with pytest.raises(ValueError, match="mesh context"):
            tl.loss_fn(params, {"tokens": torch.ones((1, 9), dtype=torch.int64)}, tcfg)


def test_reinit_on_another_device_raises():
    acc = tacc.Accelerator(device="cpu")
    assert tacc.Accelerator(cpu=True).device == acc.device == torch.device("cpu")
    for device in ("meta", "cuda", None):
        with pytest.raises(ValueError, match="already initialized on cpu"):
            tacc.Accelerator(device=device)
    AcceleratorState._reset_state()  # the process state stays on the CPU
    with pytest.raises(ValueError, match="already initialized on cpu"):
        tacc.Accelerator(device="meta")
    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()
    assert tacc.Accelerator(device="meta").device == torch.device("meta")


def test_eval_step_casts_and_runs_without_grad():
    jcfg, tcfg = _configs()
    acc = tacc.Accelerator(mixed_precision="bf16", device="cpu")
    params = acc.prepare(params_from_jax(_np_params(jcfg), tcfg, device="cpu"))
    assert all(p.dtype == torch.float32 for p in jax.tree_util.tree_leaves(params))
    bf16_cfg = dataclasses.replace(tcfg, dtype=torch.bfloat16)
    out = acc.build_eval_step(lambda p, b: tl.forward(p, b["tokens"], bf16_cfg))(
        params, {"tokens": np.ones((1, 8), np.int32)})
    assert out.dtype == torch.float32 and out.shape == (1, 8, tcfg.vocab_size)
    assert not out.requires_grad
