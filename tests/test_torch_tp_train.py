"""The port's tensor-parallel training path against the JAX package's, on the CPU:
spawned gloo ranks (the port's ``notebook_launcher``, two spawns: 4 ranks and 2) against
the JAX package on virtual CPU devices, the same seeded numpy inputs on both sides.

- ``llama.loss_fn`` with ``loss_impl="fused_tp"`` on dp2×tp2 (Megatron layout from
  ``partition_specs``, vocab-sharded head and embedding) against the JAX ``loss_fn`` on a
  dp2×tp2 mesh of four virtual devices: ``tiny``, fp32, ``attn_impl="xla"``, an untied
  head, and a tied head with ``final_softcap``; then ``fused_dp`` on dp=2. The batch's
  padding differs between the dp shards, so a mean of per-rank means would differ from
  the global mean. Tolerances are those of ``tests/test_fused_xent.py``'s fused_tp test:
  loss rtol 1e-5, every gathered gradient atol 5e-4 / rtol 1e-3.
- ``loss_impl="fused"`` with two processes runs the chunked CE (as the JAX dispatcher
  falls through on a multi-device mesh): the fused kernel's entry point never runs, and
  loss and gradients equal ``loss_impl="auto"``'s bit for bit.
- ``Accelerator.build_train_step`` over a loss that knows nothing of the mesh (a plain
  ``.mean()`` of a linear model's squared error): 3 steps of ``adamw`` with clipping on
  dp=2 against the JAX ``Accelerator`` on ``MeshConfig(dp=8)``, which gives any loss the
  global mean; losses and grad norms at rtol 1e-5, params at rtol 1e-5 / atol 1e-6.
- ``Accelerator.build_train_step``: 3 steps on dp2×tp2 (``fused_adamw``, a
  ``max_grad_norm`` small enough to clip every step) against the JAX ``Accelerator``
  on ``MeshConfig(dp=4, tp=2)`` over all 8 virtual devices with the same partition
  specs; the layouts differ only in the order of sums. Losses and grad norms at rtol
  1e-5; the gathered params after every step within lr/2 everywhere and 99.9% of them
  within 2e-6 + 1e-5 relative (AdamW divides by the root of the second moment, so an
  element whose gradient is rounding noise may move by a fraction of lr on one side).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax.sharding import NamedSharding

import torch_tp_ranks
from accelerate_tpu import accelerator as jacc
from accelerate_tpu.models import llama as jl
from accelerate_tpu.ops import fused_optim as jfo
from accelerate_tpu.parallel import MeshConfig, build_mesh
from accelerate_tpu_torch.launchers import notebook_launcher

LOSS_CASES = {
    "fused_tp_untied": {"loss_impl": "fused_tp"},
    "fused_tp_tied_softcap": {"loss_impl": "fused_tp", "tie_embeddings": True,
                              "final_softcap": 20.0},
}
DP_CASES = {
    "fused_dp": {"loss_impl": "fused_dp"},
    "fused_two_processes": {"loss_impl": "fused"},
    "auto": {"loss_impl": "auto"},
}
TRAIN_CFG = {"loss_impl": "fused_tp"}
LR, CLIP = 1e-3, 0.05


def _jcfg(cfg_kw):
    return dataclasses.replace(jl.CONFIGS["tiny"], **{"dtype": jnp.float32,
                                                      "attn_impl": "xla", **cfg_kw})


def _np_params(cfg_kw, seed):
    return jax.tree.map(np.array, jl.init_params(_jcfg(cfg_kw), jax.random.PRNGKey(seed)))


def _batch(seed):
    """4 rows of 17 tokens; rows 2-3 (the second dp shard of two) padded from slot 9."""
    rng = np.random.default_rng(seed)
    mask = np.ones((4, 17), np.float32)
    mask[2:, 9:] = 0.0
    mask[3, 5:] = 0.0
    return {"tokens": rng.integers(0, 256, (4, 17)).astype(np.int32), "mask": mask}


def _params_for(cases, seed=0):
    return {name: _np_params(kw, seed) for name, kw in cases.items()}


def _torch_kw(cfg_kw):
    return {**cfg_kw, "attn_impl": "xla"}


@functools.lru_cache(maxsize=None)
def _ranks_dp2_tp2():
    jobs = [
        ("loss_and_grads", (_params_for(LOSS_CASES), _batch(0),
                            {k: _torch_kw(v) for k, v in LOSS_CASES.items()},
                            {"dp": 2, "tp": 2})),
        ("train_steps", (_np_params(TRAIN_CFG, 2), [_batch(10 + i) for i in range(3)],
                         _torch_kw(TRAIN_CFG), {"dp": 2, "tp": 2}, LR, CLIP)),
    ]
    return notebook_launcher(torch_tp_ranks.run_all, (jobs,), 4, device="cpu",
                             backend="gloo", timeout_s=300)


def _mean_loss_inputs():
    """A linear model (8 -> 4) and 3 batches of 8 rows, from seed 7."""
    rng = np.random.default_rng(7)
    params = {"w": rng.standard_normal((8, 4)).astype(np.float32),
              "b": rng.standard_normal(4).astype(np.float32)}
    batches = [{"x": rng.standard_normal((8, 8)).astype(np.float32),
                "y": rng.standard_normal((8, 4)).astype(np.float32)} for _ in range(3)]
    return params, batches


@functools.lru_cache(maxsize=None)
def _ranks_dp2():
    jobs = [("loss_and_grads", (_params_for(DP_CASES), _batch(0),
                                {k: _torch_kw(v) for k, v in DP_CASES.items()}, {"dp": 2})),
            ("mean_loss_train_steps", (*_mean_loss_inputs(), {"dp": 2}, LR, CLIP))]
    return notebook_launcher(torch_tp_ranks.run_all, (jobs,), 2, device="cpu",
                             backend="gloo", timeout_s=300)


def _jax_loss_and_grads(np_params, cfg_kw, mesh_kw):
    cfg = _jcfg(cfg_kw)
    n = int(np.prod(list(mesh_kw.values())))
    mesh = build_mesh(MeshConfig(**mesh_kw, devices=jax.devices()[:n]))
    sharded = jax.tree_util.tree_map(lambda leaf, spec: jax.device_put(
        jnp.asarray(leaf), NamedSharding(mesh, spec)), np_params, jl.partition_specs(cfg))
    batch = jax.tree.map(jnp.asarray, _batch(0))
    with jax.set_mesh(mesh):
        loss, grads = jax.jit(jax.value_and_grad(lambda p, b: jl.loss_fn(p, b, cfg)))(
            sharded, batch)
    return float(loss), jax.tree.map(np.asarray, grads)


def _grads_close(got, want):
    got, want = jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=5e-4, rtol=1e-3)


@pytest.mark.parametrize("case", list(LOSS_CASES))
def test_loss_fused_tp_dp2_tp2_matches_jax(case):
    loss, grads = _jax_loss_and_grads(_params_for(LOSS_CASES)[case], LOSS_CASES[case],
                                      {"dp": 2, "tp": 2})
    ranks = _ranks_dp2_tp2()
    assert len(ranks) == 4
    for rank in ranks:
        got = rank[0][case]
        np.testing.assert_allclose(got["loss"], loss, rtol=1e-5)
        _grads_close(got["grads"], grads)
        assert got["kernel_calls"] == 0  # fused_tp runs the vocab-sharded kernel only


def test_loss_fused_dp_dp2_matches_jax():
    loss, grads = _jax_loss_and_grads(_params_for(DP_CASES)["fused_dp"], DP_CASES["fused_dp"],
                                      {"dp": 2})
    for rank in _ranks_dp2():
        got = rank[0]["fused_dp"]
        np.testing.assert_allclose(got["loss"], loss, rtol=1e-5)
        _grads_close(got["grads"], grads)
        assert got["kernel_calls"] == 1  # the single-shard kernel, on this rank's tokens


def test_fused_with_two_processes_runs_the_chunked_ce():
    loss, _ = _jax_loss_and_grads(_params_for(DP_CASES)["auto"], DP_CASES["auto"], {"dp": 2})
    for rank in _ranks_dp2():
        fused, auto = rank[0]["fused_two_processes"], rank[0]["auto"]
        assert fused["kernel_calls"] == 0
        assert fused["loss"] == auto["loss"]
        np.testing.assert_allclose(fused["loss"], loss, rtol=1e-5)
        for g, w in zip(jax.tree_util.tree_leaves(fused["grads"]),
                        jax.tree_util.tree_leaves(auto["grads"])):
            assert np.array_equal(g, w)


def _jax_train():
    cfg = _jcfg(TRAIN_CFG)
    acc = jacc.Accelerator(mesh_config=MeshConfig(dp=4, tp=2))
    state = acc.create_train_state(jax.tree.map(jnp.asarray, _np_params(TRAIN_CFG, 2)),
                                   jfo.fused_adamw(LR), partition_specs=jl.partition_specs(cfg))
    step = acc.build_train_step(lambda p, b: jl.loss_fn(p, b, cfg), max_grad_norm=CLIP)
    out = {"losses": [], "grad_norms": [], "params": []}
    for i in range(3):
        state, metrics = step(state, jax.tree.map(jnp.asarray, _batch(10 + i)))
        out["losses"].append(float(metrics["loss"]))
        out["grad_norms"].append(float(metrics["grad_norm"]))
        out["params"].append(jax.tree.map(np.array, state.params))  # copies: donated next
    return out


def test_train_steps_dp2_tp2_match_jax_dp4_tp2():
    want = _jax_train()
    assert min(want["grad_norms"]) > 10 * CLIP  # every step clips
    for rank in _ranks_dp2_tp2():
        got = rank[1]
        assert got["distributed_type"] == "HYBRID"
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
        np.testing.assert_allclose(got["grad_norms"], want["grad_norms"], rtol=1e-5)
        for g_tree, w_tree in zip(got["params"], want["params"]):
            g = np.concatenate([np.ravel(x) for x in jax.tree_util.tree_leaves(g_tree)])
            w = np.concatenate([np.ravel(x) for x in jax.tree_util.tree_leaves(w_tree)])
            diff = np.abs(g - w)
            assert diff.max() <= LR / 2
            assert np.mean(diff <= 2e-6 + 1e-5 * np.abs(w)) >= 0.999


def test_plain_mean_loss_train_steps_dp2_match_jax():
    params, batches = _mean_loss_inputs()
    acc = jacc.Accelerator(mesh_config=MeshConfig(dp=8))
    state = acc.create_train_state(jax.tree.map(jnp.asarray, params), optax.adamw(LR))
    step = acc.build_train_step(
        lambda p, b: jnp.mean((b["x"] @ p["w"] + p["b"] - b["y"]) ** 2), max_grad_norm=CLIP)
    want = {"losses": [], "grad_norms": [], "params": []}
    for batch in batches:
        state, metrics = step(state, jax.tree.map(jnp.asarray, batch))
        want["losses"].append(float(metrics["loss"]))
        want["grad_norms"].append(float(metrics["grad_norm"]))
        want["params"].append(jax.tree.map(np.array, state.params))
    assert min(want["grad_norms"]) > 10 * CLIP  # every step clips
    for rank in _ranks_dp2():
        got = rank[1]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
        np.testing.assert_allclose(got["grad_norms"], want["grad_norms"], rtol=1e-5)
        for g_tree, w_tree in zip(got["params"], want["params"]):
            for k in w_tree:
                np.testing.assert_allclose(g_tree[k], w_tree[k], rtol=1e-5, atol=1e-6)
