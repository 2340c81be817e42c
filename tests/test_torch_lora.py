"""The port's LoRA adapters against the JAX package's, on the CPU (``tiny``, fp32).

Mirrors ``tests/test_lora.py`` (its training test on one process: fsdp is not ported;
3 steps) and adds:

- ``only_lora`` files crossing between the packages in both directions (the same
  ``keystr`` keys);
- adapters over an int8 base in the closure form (the loss closes over the frozen
  quantized base, the train state holds only the adapters): the port's adapter
  gradients through ``quant_matmul``'s backward against ``jax.grad`` of the JAX loss
  (Pallas in interpret mode), and a train step that leaves the int8 codes alone;
- the frozen base never handed to ``torch.autograd.grad``, kept in the dtype it came
  in, with no accumulation buffer and no optimizer state;
- ``optim.multi_transform`` / ``set_to_zero`` against optax's;
- one gloo dp1×tp2 spawn (rank functions in ``tests/torch_tp_ranks.py``): a delayed-
  scaling fp8 step and a LoRA step (adapters on all seven projections) against the
  same steps in one process.

Tolerances are the JAX tests' own (forwards and merges 2e-5) and, against JAX, those of
``tests/test_torch_train.py``: losses rtol 1e-5; trained params within lr/2 everywhere
and 99.9% within 2e-6 + 1e-5 relative; gradients atol 2e-6 + rtol 1e-4.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_tp_ranks
from accelerate_tpu import accelerator as jacc
from accelerate_tpu.models import llama as jl
from accelerate_tpu.models import lora as jlora
from accelerate_tpu.ops import quantization as jq
from accelerate_tpu_torch import accelerator as tacc
from accelerate_tpu_torch import optim as topt
from accelerate_tpu_torch.launchers import notebook_launcher
from accelerate_tpu_torch.models import llama as tl
from accelerate_tpu_torch.models import lora
from accelerate_tpu_torch.models.convert import params_from_jax, params_to_numpy
from accelerate_tpu_torch.ops import quantization as tq
from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState
from accelerate_tpu_torch.utils.tree import tree_leaves, tree_map

J_CFG = dataclasses.replace(jl.CONFIGS["tiny"], dtype=jnp.float32, attn_impl="xla")
J_LORA = dataclasses.replace(J_CFG, lora_rank=4, lora_alpha=8.0)
T_CFG = dataclasses.replace(tl.CONFIGS["tiny"], dtype=torch.float32, attn_impl="xla")
T_LORA = dataclasses.replace(T_CFG, lora_rank=4, lora_alpha=8.0)
LR = 1e-2


@pytest.fixture(autouse=True)
def _reset_port_singletons():
    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()
    yield
    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()


def make_batch(n=8, seq=16, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, J_CFG.vocab_size, size=(n, seq + 1)).astype(np.int32)}


def _np_params(cfg, seed=0, b_scale=0.0):
    """JAX ``init_params`` as numpy, every ``_lora_b`` drawn N(0, b_scale²) from numpy."""
    params = jax.tree.map(np.array, jl.init_params(cfg, jax.random.PRNGKey(seed)))
    if b_scale:
        rng = np.random.default_rng(seed + 7)
        layers = params["layers"]
        for layer in (layers if isinstance(layers, list) else [layers]):
            for k in layer:
                if k.endswith("_lora_b"):
                    layer[k] = (rng.standard_normal(layer[k].shape) * b_scale).astype(np.float32)
    return params


def _j_forward(np_params, tokens, cfg):
    return np.asarray(jl.forward(jax.tree.map(jnp.asarray, np_params), jnp.asarray(tokens), cfg,
                                 shard_activations=False))


def _t_forward(params, tokens, cfg):
    with torch.no_grad():
        return tl.forward(params, torch.as_tensor(tokens), cfg).numpy()


def _tokens():
    return make_batch(2, 12)["tokens"][:, :-1]


def _flat(tree) -> np.ndarray:
    return np.concatenate([np.ravel(np.asarray(x)) for x in jax.tree_util.tree_leaves(tree)])


def _params_close(got, want, lr=LR):
    diff = np.abs(got - want)
    assert diff.max() <= lr / 2
    assert np.mean(diff <= 2e-6 + 1e-5 * np.abs(want)) >= 0.999


# --------------------------------------------------------------- the JAX suite's tests
def test_zero_init_matches_base_exactly():
    g = lambda: torch.Generator().manual_seed(0)  # noqa: E731
    base = tl.init_params(T_CFG, generator=g(), device="cpu")
    adapted = tl.init_params(T_LORA, generator=g(), device="cpu")
    assert torch.equal(base["layers"][0]["wq"], adapted["layers"][0]["wq"])
    assert np.array_equal(_t_forward(base, _tokens(), T_CFG),
                          _t_forward(adapted, _tokens(), T_LORA))
    np_adapted = _np_params(J_LORA)
    np.testing.assert_allclose(
        _t_forward(params_from_jax(np_adapted, T_LORA, device="cpu"), _tokens(), T_LORA),
        _j_forward(np_adapted, _tokens(), J_LORA), atol=2e-5)


def test_partition_specs_cover_adapters():
    params = tl.init_params(T_LORA, device="cpu")
    specs = tl.partition_specs(T_LORA)
    tree_map(lambda p, s: None, params, specs)  # the structures match, or this raises
    assert specs["layers"][0]["wq_lora_b"] == (None, "tp")
    assert specs["layers"][0]["wo_lora_a"] == ("tp", None)
    want = jl.partition_specs(J_LORA)["layers"][0]
    for name, spec in specs["layers"][0].items():
        assert tuple(spec) == tuple(want[name]), name


def _jax_train(np_params, steps=3):
    from accelerate_tpu.utils import host_snapshot

    acc = jacc.Accelerator()
    state = acc.create_train_state(jax.tree.map(jnp.asarray, np_params),
                                   jlora.lora_optimizer(optax.adamw(LR)))
    step = acc.build_train_step(lambda p, b: jl.loss_fn(p, b, J_LORA))
    losses = []
    for _ in range(steps):
        state, metrics = step(state, make_batch(seed=0))
        losses.append(float(np.asarray(metrics["loss"])))
    return losses, host_snapshot(state.params)


def test_training_updates_only_adapters():
    np_params = _np_params(J_LORA)
    want_losses, want_params = _jax_train(np_params)
    acc = tacc.Accelerator(device="cpu")
    state = acc.create_train_state(params_from_jax(np_params, T_LORA, device="cpu"),
                                   lora.lora_optimizer(topt.adamw(LR)))
    base_before = state.params["layers"][0]["wq"].clone()
    adapter_before = state.params["layers"][0]["wq_lora_b"].clone()
    step = acc.build_train_step(lambda p, b: tl.loss_fn(p, b, T_LORA))
    losses = []
    for _ in range(3):
        state, metrics = step(state, make_batch(seed=0))
        losses.append(float(metrics["loss"]))
    assert torch.equal(base_before, state.params["layers"][0]["wq"])
    assert not torch.equal(adapter_before, state.params["layers"][0]["wq_lora_b"])
    assert losses[-1] < losses[0], losses
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    _params_close(_flat(params_to_numpy(state.params)), _flat(want_params))


def test_merge_matches_adapted_forward():
    np_params = _np_params(J_LORA, b_scale=0.02)
    params = params_from_jax(np_params, T_LORA, device="cpu")
    merged, merged_cfg = lora.merge_lora(params, T_LORA)
    assert merged_cfg.lora_rank == 0 and "wq_lora_a" not in merged["layers"][0]
    np.testing.assert_allclose(_t_forward(merged, _tokens(), merged_cfg),
                               _t_forward(params, _tokens(), T_LORA), atol=2e-5)
    j_merged, _ = jlora.merge_lora(jax.tree.map(jnp.asarray, np_params), J_LORA)
    np.testing.assert_allclose(_flat(params_to_numpy(merged)), _flat(j_merged),
                               rtol=1e-6, atol=1e-7)


def test_merge_scan_layers_stacked():
    cfg = dataclasses.replace(J_LORA, scan_layers=True)
    np_params = _np_params(cfg, b_scale=0.02)
    j_merged, j_cfg = jlora.merge_lora(jax.tree.map(jnp.asarray, np_params), cfg)
    stacked = {k: torch.from_numpy(v) for k, v in np_params["layers"].items()}
    got = lora.merge_lora_trees(stacked, T_LORA)
    assert sorted(got) == sorted(j_merged["layers"])
    for k, v in got.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(j_merged["layers"][k]),
                                   rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(
        _t_forward(params_from_jax(np_params, T_LORA, device="cpu"), _tokens(), T_LORA),
        _j_forward(jax.tree.map(np.asarray, j_merged), _tokens(), j_cfg), atol=2e-5)


def test_decode_path_applies_adapters():
    from accelerate_tpu.generation import GenerationConfig as JGen
    from accelerate_tpu_torch.generation import GenerationConfig

    gen = GenerationConfig(max_new_tokens=6)
    prompt = torch.tensor([[3, 5, 7, 9]], dtype=torch.int32)
    base = params_from_jax(_np_params(J_CFG), T_CFG, device="cpu")
    zeroed = params_from_jax(_np_params(J_LORA), T_LORA, device="cpu")
    want_base = tl.generate(base, prompt, T_CFG, gen=gen)
    assert torch.equal(want_base, tl.generate(zeroed, prompt, T_LORA, gen=gen))
    bumped_np = _np_params(J_LORA)
    for layer in bumped_np["layers"]:
        for k in layer:
            if k.endswith("_lora_b"):
                layer[k] = np.full(layer[k].shape, 0.05, np.float32)
    bumped = params_from_jax(bumped_np, T_LORA, device="cpu")
    out = tl.generate(bumped, prompt, T_LORA, gen=gen)
    assert not torch.equal(out, want_base), "nonzero adapters must change generations"
    want = jl.generate(jax.tree.map(jnp.asarray, bumped_np), jnp.asarray(prompt.numpy()),
                       J_LORA, gen=JGen(max_new_tokens=6))
    assert np.array_equal(out.numpy(), np.asarray(want))


def test_add_adapters_to_pretrained_params():
    base = tl.init_params(T_CFG, device="cpu")
    params = lora.add_adapters(base, T_LORA)
    assert np.array_equal(_t_forward(base, _tokens(), T_CFG),
                          _t_forward(params, _tokens(), T_LORA))
    assert params["layers"][0]["wq"] is base["layers"][0]["wq"]  # shared, not copied
    tree_map(lambda p, s: None, params, tl.partition_specs(T_LORA))
    with pytest.raises(ValueError, match="already carry adapters"):
        lora.add_adapters(params, T_LORA)
    with pytest.raises(ValueError, match="lora_rank > 0"):
        lora.add_adapters(base, T_CFG)
    # A scanned JAX checkpoint, unstacked by the conversion, adapts per layer.
    scan = params_from_jax(_np_params(dataclasses.replace(J_CFG, scan_layers=True)),
                           T_CFG, device="cpu")
    adapted = lora.add_adapters(scan, T_LORA)
    assert adapted["layers"][1]["wq_lora_a"].shape == (T_CFG.d_model, T_LORA.lora_rank)


def test_adapter_checkpoint_roundtrip():
    params = tl.init_params(T_LORA, device="cpu")
    trained = tree_map(lambda x: x + 1.0, params)
    adapters = lora.only_lora(trained)
    restored = lora.load_lora(params, adapters)
    assert torch.equal(restored["layers"][0]["wq_lora_b"], trained["layers"][0]["wq_lora_b"])
    assert torch.equal(restored["layers"][0]["wq"], params["layers"][0]["wq"])
    with pytest.raises(KeyError, match="missing"):
        lora.load_lora(params, dict(list(adapters.items())[1:]))
    with pytest.raises(KeyError, match="extra"):
        lora.load_lora(params, {**adapters, "bogus": np.zeros(2)})
    key = next(iter(adapters))
    with pytest.raises(ValueError, match="checkpoint shape"):
        lora.load_lora(params, {**adapters, key: np.zeros(3)})


def test_only_lora_is_small():
    params = tl.init_params(T_LORA, device="cpu")
    adapters = lora.only_lora(params)
    assert adapters and all("_lora_" in k for k in adapters)
    n_adapter = sum(v.numel() for v in adapters.values())
    assert n_adapter < sum(v.numel() for v in tree_leaves(params)) * 0.2
    assert lora.lora_mask(params)["layers"][0]["wq_lora_a"] is True
    assert lora.lora_mask(params)["layers"][0]["wq"] is False


def test_bad_target_raises():
    with pytest.raises(ValueError, match="dense projection"):
        tl.init_params(dataclasses.replace(T_CFG, lora_rank=2, lora_targets=("embed",)),
                       device="cpu")


# ------------------------------------------------------------------------- additions
def test_only_lora_files_cross_between_packages(tmp_path):
    np_params = _np_params(J_LORA, b_scale=0.02)
    j_adapters = jlora.only_lora(jax.tree.map(jnp.asarray, np_params))
    t_params = params_from_jax(np_params, T_LORA, device="cpu")
    t_adapters = lora.only_lora(t_params)
    assert sorted(j_adapters) == sorted(t_adapters)
    assert "['layers'][0]['wq_lora_a']" in t_adapters
    # JAX's file into the port ...
    np.savez(tmp_path / "jax.npz", **{k: np.asarray(v) for k, v in j_adapters.items()})
    fresh = params_from_jax(_np_params(J_LORA, seed=3), T_LORA, device="cpu")
    loaded = lora.only_lora(lora.load_lora(fresh, dict(np.load(tmp_path / "jax.npz"))))
    assert all(np.array_equal(loaded[k].numpy(), np.asarray(j_adapters[k])) for k in loaded)
    # ... and the port's into JAX.
    np.savez(tmp_path / "port.npz", **{k: v.numpy() for k, v in t_adapters.items()})
    j_fresh = jax.tree.map(jnp.asarray, _np_params(J_LORA, seed=3))
    j_loaded = jlora.only_lora(jlora.load_lora(j_fresh, dict(np.load(tmp_path / "port.npz"))))
    assert all(np.array_equal(np.asarray(j_loaded[k]), t_adapters[k].numpy()) for k in j_loaded)


def _int8_closure_inputs():
    """The JAX int8 base (projections quantized, embed and head skipped) as numpy, and
    adapters of rank 4 drawn from numpy (B nonzero)."""
    base = jl.init_params(J_CFG, jax.random.PRNGKey(0))
    qbase = jq.load_and_quantize_model(base, jq.BnbQuantizationConfig(
        load_in_8bit=True, skip_modules=["embed", "lm_head"]))
    rng = np.random.default_rng(11)
    D, r = J_CFG.d_model, J_LORA.lora_rank
    outs = {"wq": J_CFG.n_heads * J_CFG.head_dim, "wk": J_CFG.n_kv_heads * J_CFG.head_dim,
            "wv": J_CFG.n_kv_heads * J_CFG.head_dim, "wo": D}
    adapters = {"layers": [
        {**{f"{n}_lora_a": (rng.standard_normal((D, r)) / np.sqrt(D)).astype(np.float32)
            for n in outs},
         **{f"{n}_lora_b": (rng.standard_normal((r, d)) * 0.02).astype(np.float32)
            for n, d in outs.items()}} for _ in range(J_CFG.n_layers)]}
    return jax.tree.map(np.asarray, qbase), adapters


def _with_adapters(base, adapters):
    return {**base, "layers": [{**b, **a} for b, a in zip(base["layers"], adapters["layers"])]}


def test_adapter_grads_over_int8_base_match_jax():
    np_base, np_adapters = _int8_closure_inputs()
    batch = make_batch(2, 8, seed=2)
    jbase = jax.tree.map(jnp.asarray, np_base)

    def jloss(ad):
        return jl.loss_fn(_with_adapters(jbase, ad), jax.tree.map(jnp.asarray, batch), J_LORA)

    j_loss, j_grads = jax.jit(jax.value_and_grad(jloss))(jax.tree.map(jnp.asarray, np_adapters))
    tbase = params_from_jax(np_base, T_CFG, device="cpu")
    assert isinstance(tbase["layers"][0]["wq"], tq.QuantizedWeight)
    tad = tree_map(lambda a: torch.tensor(a, requires_grad=True), np_adapters)
    t_loss = tl.loss_fn(_with_adapters(tbase, tad), {"tokens": torch.as_tensor(batch["tokens"])},
                        T_LORA)
    t_grads = torch.autograd.grad(t_loss, tree_leaves(tad))
    np.testing.assert_allclose(float(t_loss), float(j_loss), rtol=1e-5)
    for got, want in zip(t_grads, jax.tree_util.tree_leaves(j_grads)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6, rtol=1e-4)
    # The closure through the train step: the state holds only the adapters.
    codes = [leaf.data.clone() for layer in tbase["layers"] for leaf in layer.values()
             if isinstance(leaf, tq.QuantizedWeight)]
    acc = tacc.Accelerator(device="cpu")
    state = acc.create_train_state(tree_map(torch.tensor, np_adapters), topt.adamw(LR))
    step = acc.build_train_step(lambda ad, b: tl.loss_fn(_with_adapters(tbase, ad), b, T_LORA))
    losses = []
    for _ in range(3):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0]
    after = [leaf.data for layer in tbase["layers"] for leaf in layer.values()
             if isinstance(leaf, tq.QuantizedWeight)]
    assert all(torch.equal(a, b) for a, b in zip(codes, after))


def test_quantized_train_state_refused_with_the_closure_form():
    np_base, _ = _int8_closure_inputs()
    acc = tacc.Accelerator(device="cpu")
    with pytest.raises(NotImplementedError, match="QLoRA") as info:
        acc.create_train_state(params_from_jax(np_base, T_CFG, device="cpu"), topt.adamw(LR))
    assert "closure form" in str(info.value) and "JAX package" in str(info.value)


def test_frozen_base_never_takes_a_gradient(monkeypatch):
    params = lora.add_adapters(tl.init_params(dataclasses.replace(T_CFG, dtype=torch.bfloat16),
                                              device="cpu"), T_LORA)
    base = {id(t) for path, t in zip(range(10 ** 6), tree_leaves(params))
            if t.dtype == torch.bfloat16}
    acc = tacc.Accelerator(device="cpu", mixed_precision="bf16", gradient_accumulation_steps=2)
    state = acc.create_train_state(params, lora.lora_optimizer(topt.adamw(LR)))
    kept = [t for t in tree_leaves(state.params) if id(t) in base]
    assert len(kept) == len(base)  # the bf16 base enters the state as it is: no fp32 copy
    assert all(t.dtype == torch.float32 for t in lora.only_lora(state.params).values())
    n_adapters = len(lora.only_lora(state.params))
    assert len(tree_leaves(state.grad_accum)) == n_adapters  # no buffer for the base
    assert tree_leaves(state.opt_state.inner_states["frozen"]) == []
    seen = []
    grad = torch.autograd.grad

    def recording(outputs, inputs, *a, **kw):
        seen.append([id(t) for t in inputs])
        return grad(outputs, inputs, *a, **kw)

    monkeypatch.setattr(torch.autograd, "grad", recording)
    step = acc.build_train_step(lambda p, b: tl.loss_fn(p, b, T_LORA))
    before = [t.clone() for t in kept]
    for _ in range(2):
        state, _ = step(state, make_batch(seed=1))
    assert len(seen) == 2 and all(len(ids) == n_adapters for ids in seen)
    assert not any(i in base for ids in seen for i in ids)
    assert all(torch.equal(a, b) and b.grad is None for a, b in zip(before, kept))


def test_multi_transform_matches_optax():
    rng = np.random.default_rng(4)
    params = {"a": rng.standard_normal((4, 3)).astype(np.float32),
              "b": [rng.standard_normal(5).astype(np.float32)],
              "c": rng.standard_normal(2).astype(np.float32)}
    grads = [jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(np.float32), params)
             for _ in range(2)]
    labels = {"a": "adam", "b": ["sgd"], "c": "frozen"}
    jtx = optax.multi_transform({"adam": optax.adamw(0.1), "sgd": optax.sgd(0.1),
                                 "frozen": optax.set_to_zero()}, labels)
    ttx = topt.multi_transform({"adam": topt.adamw(0.1), "sgd": topt.sgd(0.1),
                                "frozen": topt.set_to_zero()}, labels)
    jp, tp = jax.tree.map(jnp.asarray, params), tree_map(torch.tensor, params)
    js, ts = jtx.init(jp), ttx.init(tp)
    assert tree_leaves(ts.inner_states["frozen"]) == []
    assert ttx.frozen_leaves(tp) == [False, False, True]
    for g in grads:
        ju, js = jtx.update(jax.tree.map(jnp.asarray, g), js, jp)
        tu, ts = ttx.update(tree_map(torch.tensor, g), ts, tp)
        jp, tp = optax.apply_updates(jp, ju), topt.apply_updates(tp, tu)
        for got, want in zip(tree_leaves(tu), jax.tree_util.tree_leaves(ju)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="no transformation"):
        topt.multi_transform({"adam": topt.adamw(0.1)}, labels).init(tp)


# ------------------------------------------------------------------ tp: fp8 and LoRA
TP_CASES = {
    "fp8": {"use_fp8": True},
    "lora": {"lora_rank": 4, "lora_alpha": 8.0,
             "lora_targets": ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")},
}


def _tp_inputs(case):
    cfg = dataclasses.replace(J_CFG, **TP_CASES[case])
    return _np_params(cfg, seed=5, b_scale=0.05 if case == "lora" else 0.0), \
        [make_batch(4, 16, seed=20 + i) for i in range(3)]


@functools.lru_cache(maxsize=None)
def _tp_ranks():
    jobs = [("fp8_lora_steps", (*_tp_inputs(case), TP_CASES[case], {"dp": 1, "tp": 2}, LR))
            for case in TP_CASES]
    return notebook_launcher(torch_tp_ranks.run_all, (jobs,), 2, device="cpu",
                             backend="gloo", timeout_s=300)


@pytest.mark.parametrize("case", list(TP_CASES))
def test_tp_fp8_and_lora_steps_match_one_process(case):
    want = torch_tp_ranks.fp8_lora_steps(*_tp_inputs(case), TP_CASES[case], None, LR)
    for rank in _tp_ranks():
        got = rank[list(TP_CASES).index(case)]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
        for g, w in zip(got["params"], want["params"]):
            _params_close(_flat(g), _flat(w))
        if case == "fp8":
            np.testing.assert_allclose(got["history"], want["history"], rtol=1e-6)
        else:
            assert got["adapters_moved"] and got["base_unchanged"]
