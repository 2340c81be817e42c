"""The port's ZeRO/FSDP training path against the JAX package's, on the CPU: spawned
gloo ranks (the port's ``notebook_launcher``, one spawn of 2 ranks and one of 4) against
the JAX package on virtual CPU devices, the same seeded numpy inputs on both sides.

- ``FullyShardedDataParallelPlugin``: every strategy's ZeRO stage and the launcher
  environment's priority (explicit > ``ACCELERATE_FSDP_*`` > default), field for field
  with JAX's plugin; ``infer_fsdp_spec`` on random shapes, sizes and existing specs and
  ``MeshConfig.from_plugins`` (fsdp, tp+fsdp, HYBRID, NO_SHARD) equal to JAX's.
- ZeRO 0/1/2/3 on JAX's ``tests/test_zero.py`` problem (a two-layer tanh MLP, 16 rows,
  ``adamw(1e-2)``, ``min_weight_size=1``): 2 ranks (dp1×fsdp2; stage 0 on dp=2)
  against the JAX ``Accelerator`` on ``MeshConfig(dp=1, fsdp=8)`` (stage 0: dp=8): losses
  at rtol 2e-5 (JAX's own parity tolerance), the gathered params at rtol 1e-5 / atol
  1e-6; ZeRO-2 with accumulation; ``fused_adamw`` on every stage's shards with a
  ``max_grad_norm`` that clips every step (grad norms at rtol 1e-5). Each stage's
  pieces are the ones it promises: ZeRO-3 params and moments, ZeRO-1/2 moments (and
  ZeRO-2 accumulation buffers) split, ZeRO-3's resident state half of one rank's.
- ``cpu_offload`` (one process, the host being the device): ``adamw`` and
  ``fused_adamw`` with and without accumulation against JAX's stage-0 run (rtol 2e-5);
  the fused stream in chunks of 1024 elements bitwise equal to the apply without
  offload.
- tiny llama at ZeRO-3 on packed batches (``ops.packing.pack_sequences`` rows with
  segments and positions; full remat): dp1×fsdp2, the per-layer gather
  (``gathers_fsdp_shards``, inside each remat unit: the recompute gathers again) and the
  whole-tree gather, ``fused_adamw`` with clipping, against the JAX ``Accelerator``
  on ``MeshConfig(dp=4, fsdp=2)`` with ZeRO-3: losses and grad norms at rtol 1e-5, the
  params after every step within lr/2 everywhere and 99.9% of them within 2e-6 + 1e-5
  relative (``tests/test_torch_tp_train.py``'s rule: AdamW divides by the root of the
  second moment, so an element whose gradient is rounding noise may move by a fraction
  of lr); the per-layer and whole-tree gathers give the same bits.
- dp1×fsdp2×tp2 on 4 ranks: the placed specs equal JAX's ``apply_tensor_parallel`` with
  the plugin, and the ``fused_tp`` losses JAX's on ``MeshConfig(dp=2, fsdp=2, tp=2)``.
- a LoRA state and an fp8 (delayed scaling, O2 moments) step under ZeRO-3 on 2 ranks
  against the port's one-process run (which ``test_torch_lora.py`` and
  ``test_torch_fp8.py`` hold against JAX): losses at rtol 1e-5, params by the rule
  above; an fp8 amax is global over every rank of the mesh, as GSPMD's is.
"""

import dataclasses
import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_tp_ranks
from accelerate_tpu import Accelerator as JAccelerator
from accelerate_tpu.models import llama as jl
from accelerate_tpu.ops import fused_optim as jfo
from accelerate_tpu.ops import packing as jpk
from accelerate_tpu.parallel import MeshConfig as JMeshConfig
from accelerate_tpu.parallel import build_mesh as jbuild_mesh
from accelerate_tpu.parallel import fsdp as jfsdp
from accelerate_tpu.parallel.tp import apply_tensor_parallel as japply_tp
from accelerate_tpu.state import AcceleratorState as JAS
from accelerate_tpu.state import GradientState as JGS
from accelerate_tpu.state import PartialState as JPS
from accelerate_tpu.utils import FullyShardedDataParallelPlugin as JPlugin
from accelerate_tpu.utils import send_to_device
from accelerate_tpu.utils.dataclasses import TensorParallelPlugin as JTP
from accelerate_tpu_torch import optim
from accelerate_tpu_torch.accelerator import Accelerator
from accelerate_tpu_torch.launchers import notebook_launcher
from accelerate_tpu_torch.ops import fused_optim as tfo
from accelerate_tpu_torch.parallel import MeshConfig, P, infer_fsdp_spec
from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState
from accelerate_tpu_torch.utils.dataclasses import (FSDPShardingStrategy,
                                                    FullyShardedDataParallelPlugin)

LR, CLIP = 1e-3, 0.05


@pytest.fixture(autouse=True)
def _fresh_state():
    for cls in (AcceleratorState, GradientState, PartialState, JAS, JGS, JPS):
        cls._reset_state()
    yield
    for cls in (AcceleratorState, GradientState, PartialState, JAS, JGS, JPS):
        cls._reset_state()


# ----------------------------------------------------------------------- plugin and specs
ENV_CASES = {"none": {}, "env": {"ACCELERATE_FSDP_ZERO_STAGE": "1",
                                 "ACCELERATE_FSDP_MIN_WEIGHT_SIZE": "64",
                                 "ACCELERATE_FSDP_CPU_OFFLOAD": "true",
                                 "ACCELERATE_FSDP_STATE_DICT_TYPE": "FULL_STATE_DICT"}}


@pytest.mark.parametrize("env", list(ENV_CASES))
@pytest.mark.parametrize("strategy", FSDPShardingStrategy.list())
def test_plugin_stage_mapping_and_env_priority(monkeypatch, strategy, env):
    for key, value in ENV_CASES[env].items():
        monkeypatch.setenv(key, value)

    def fields(plugin):
        return {k: str(v) for k, v in dataclasses.asdict(plugin).items()}

    for kw in ({}, {"zero_stage": 3, "min_weight_size": 2}, {"state_dict_type": "SHARDED"}):
        got = FullyShardedDataParallelPlugin(sharding_strategy=strategy, **kw)
        want = JPlugin(sharding_strategy=strategy, **kw)
        assert fields(got) == fields(want)
        assert (got.shards_params, got.shards_grads, got.shards_optimizer) == (
            want.shards_params, want.shards_grads, want.shards_optimizer)


@pytest.mark.parametrize("seed", range(4))
def test_infer_fsdp_spec_matches_jax(seed):
    rng = np.random.default_rng(seed)
    axes = [None, "tp", ("tp", "fsdp"), "fsdp"]
    for _ in range(200):
        ndim = int(rng.integers(1, 4))
        shape = tuple(int(rng.choice([1, 2, 3, 4, 6, 8, 12, 16, 64, 96, 128])) for _ in range(ndim))
        size = int(rng.choice([1, 2, 4, 8]))
        min_size = int(rng.choice([1, 64, 1024]))
        existing = None
        if rng.random() < 0.5:
            existing = [axes[int(rng.integers(0, len(axes)))] for _ in range(ndim)]
        got = infer_fsdp_spec(shape, size, min_size, None if existing is None else P(*existing))
        want = jfsdp.infer_fsdp_spec(shape, size, min_size, None if existing is None
                                     else jax.sharding.PartitionSpec(*existing))
        assert tuple(got) == tuple(want), (shape, size, min_size, existing)


FROM_PLUGINS = {
    "fsdp": ({"zero_stage": 3}, None, 8),
    "zero1": ({"zero_stage": 1}, None, 4),
    "tp_fsdp": ({"zero_stage": 3}, 2, 8),
    "hybrid": ({"sharding_strategy": "HYBRID_SHARD"}, None, 16),
    "hybrid_zero2_tp": ({"sharding_strategy": "HYBRID_SHARD_ZERO2"}, 2, 32),
    "no_shard": ({"sharding_strategy": "NO_SHARD"}, None, 8),
    "no_plugin": (None, 2, 8),
}


@pytest.mark.parametrize("case", list(FROM_PLUGINS))
def test_from_plugins_matches_jax(monkeypatch, case):
    kw, tp, n = FROM_PLUGINS[case]
    # JAX's HYBRID shards within a host's local devices: the port's within a node's
    # processes (LOCAL_WORLD_SIZE), set to the JAX process's local device count.
    monkeypatch.setenv("LOCAL_WORLD_SIZE", str(jax.local_device_count()))
    got = MeshConfig.from_plugins(
        fsdp_plugin=None if kw is None else FullyShardedDataParallelPlugin(**kw),
        tp_plugin=None if tp is None else SimpleNamespace(tp_size=tp), num_devices=n)
    want = JMeshConfig.from_plugins(
        fsdp_plugin=None if kw is None else JPlugin(**kw),
        tp_plugin=None if tp is None else JTP(tp_size=tp), num_devices=n)
    assert dataclasses.asdict(got) == {k: v for k, v in dataclasses.asdict(want).items()
                                       if k in dataclasses.asdict(got)}


# ----------------------------------------------------------------- the ZeRO test's problem
def _make_problem(seed=0):
    """``tests/test_zero.py::_make_problem`` with numpy leaves."""
    rng = np.random.default_rng(seed)
    params = {"w1": (rng.normal(size=(64, 32)) * 0.1).astype(np.float32),
              "b1": np.zeros((32,), np.float32),
              "w2": (rng.normal(size=(32, 8)) * 0.1).astype(np.float32)}
    x = rng.normal(size=(16, 64)).astype(np.float32)
    y = rng.normal(size=(16, 8)).astype(np.float32)
    return params, {"x": x, "y": y}


def _jax_loss(p, batch):
    h = jnp.tanh(batch["x"] @ p["w1"] + p["b1"])
    return jnp.mean((h @ p["w2"] - batch["y"]) ** 2)


def _jax_train(zero_stage, steps=4, accum=1, fused=False, clip=None):
    """``tests/test_zero.py::_train`` (stage 0: dp=8; else dp1×fsdp8), with the fused
    optimizer and clipping as options: losses, grad norms, the final params."""
    for cls in (JAS, JGS, JPS):
        cls._reset_state()
    params, batch = _make_problem()
    if zero_stage == 0:
        mesh_cfg, plugin = JMeshConfig(), None
    else:
        mesh_cfg = JMeshConfig(dp=1, fsdp=8)
        plugin = JPlugin(zero_stage=zero_stage, min_weight_size=1)
    acc = JAccelerator(mesh_config=mesh_cfg, fsdp_plugin=plugin,
                       gradient_accumulation_steps=accum)
    tx = jfo.fused_adamw(1e-2) if fused else optax.adamw(1e-2)
    state = acc.create_train_state(jax.tree.map(jnp.asarray, params), tx)
    step = acc.build_train_step(_jax_loss, max_grad_norm=clip)
    dbatch = send_to_device(batch, acc.mesh)
    losses, norms = [], []
    for _ in range(steps * accum):
        state, metrics = step(state, dbatch)
        losses.append(float(metrics["loss"]))
        if "grad_norm" in metrics:
            norms.append(float(metrics["grad_norm"]))
    out = losses, norms, jax.tree.map(np.asarray, state.params)
    for cls in (JAS, JGS, JPS):
        cls._reset_state()
    return out


def _plugin(stage, **kw):
    return {"zero_stage": stage, "min_weight_size": 1, **kw}


ZERO_CASES = {
    "z0": {"mesh": {"dp": 2}},
    **{f"z{s}": {"mesh": {"dp": 1, "fsdp": 2}, "plugin": _plugin(s)} for s in (1, 2, 3)},
    "z2_accum": {"mesh": {"dp": 1, "fsdp": 2}, "plugin": _plugin(2), "accum": 2, "steps": 2},
    "z0_accum": {"mesh": {"dp": 2}, "accum": 2, "steps": 2},
    **{f"z{s}_fused": {"mesh": {"dp": 1, "fsdp": 2}, "plugin": _plugin(s), "opt": "fused",
                       "clip": 0.2} for s in (1, 2, 3)},
    "z3_offload_accum": {"mesh": {"dp": 1, "fsdp": 2}, "plugin": _plugin(3, cpu_offload=True),
                         "accum": 2, "steps": 2, "opt": "fused"},
}


def _llama_cfg_kw():
    return {"attn_impl": "xla", "remat": True}


def _packed_batches(n, rows, seed):
    """``n`` batches of ``rows`` packed rows of 33 tokens (documents of 3-20 tokens)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        docs = [rng.integers(1, 256, int(rng.integers(3, 21))) for _ in range(rows * 3)]
        packed = jpk.pack_sequences(docs, 33, use_native=False)
        assert packed["tokens"].shape[0] >= rows
        out.append({k: v[:rows] for k, v in packed.items()})
    return out


def _jcfg(cfg_kw):
    return dataclasses.replace(jl.CONFIGS["tiny"], **{"dtype": jnp.float32, **cfg_kw})


def _np_llama(cfg_kw, seed):
    return jax.tree.map(np.array, jl.init_params(_jcfg(cfg_kw), jax.random.PRNGKey(seed)))


LORA_KW = {"attn_impl": "xla", "lora_rank": 4, "lora_alpha": 8.0}
FP8_KW = {"attn_impl": "xla", "use_fp8": True}


def _one_process_fp8_lora(cfg_kw, batches):
    """The same run in this process on one rank (the reference of the ZeRO-3 one)."""
    return torch_tp_ranks.fp8_lora_steps(_np_llama(cfg_kw, 4), batches, cfg_kw, None, LR)


@functools.lru_cache(maxsize=None)
def _ranks_2():
    params, batch = _make_problem()
    jobs = [
        ("zero_problem_steps", (params, batch, ZERO_CASES)),
        ("fsdp_llama_steps", (_np_llama(_llama_cfg_kw(), 2), _packed_batches(3, 8, 11),
                              _llama_cfg_kw(), {"dp": 1, "fsdp": 2}, {"zero_stage": 3}, LR,
                              CLIP, True)),
        ("fsdp_llama_steps", (_np_llama(_llama_cfg_kw(), 2), _packed_batches(3, 8, 11),
                              _llama_cfg_kw(), {"dp": 1, "fsdp": 2}, {"zero_stage": 3}, LR,
                              CLIP, False)),
        ("fp8_lora_steps", (_np_llama(LORA_KW, 4), _packed_batches(2, 4, 21), LORA_KW,
                            {"dp": 1, "fsdp": 2}, LR, {"zero_stage": 3})),
        ("fp8_lora_steps", (_np_llama(FP8_KW, 4), _packed_batches(2, 4, 21), FP8_KW,
                            {"dp": 1, "fsdp": 2}, LR, {"zero_stage": 3})),
    ]
    return notebook_launcher(torch_tp_ranks.run_all, (jobs,), 2, device="cpu",
                             backend="gloo", timeout_s=300)


TP_FSDP_CFG = {"attn_impl": "xla", "loss_impl": "fused_tp"}


@functools.lru_cache(maxsize=None)
def _ranks_4():
    jobs = [("fsdp_llama_steps", (_np_llama(TP_FSDP_CFG, 5), _packed_batches(2, 4, 31),
                                  TP_FSDP_CFG, {"dp": 1, "fsdp": 2, "tp": 2},
                                  {"zero_stage": 3}, LR, CLIP, True, True))]
    return notebook_launcher(torch_tp_ranks.run_all, (jobs,), 4, device="cpu",
                             backend="gloo", timeout_s=300)


def _zero(name):
    ranks = _ranks_2()
    r0, r1 = ranks[0][0][name], ranks[1][0][name]
    for k in r0["params"]:
        assert np.array_equal(r0["params"][k], r1["params"][k])  # the gathered params agree
    assert r0["losses"] == r1["losses"]
    return r0


@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_zero_stages_match_jax(stage):
    losses, _, params = _jax_train(stage)
    got = _zero(f"z{stage}")
    np.testing.assert_allclose(got["losses"], losses, rtol=2e-5)
    for k, v in params.items():
        np.testing.assert_allclose(got["params"][k], v, rtol=1e-5, atol=1e-6)
    assert got["distributed_type"] == ("MULTI_DEVICE" if stage == 0 else "FSDP")


def test_zero_stages_split_what_they_promise():
    z0, z1, z2, z3 = (_zero(f"z{s}") for s in range(4))
    whole = {"w1": (64, 32), "b1": (32,), "w2": (32, 8)}
    half = {"w1": (32, 32), "b1": (16,), "w2": (16, 8)}  # the largest dim split, as JAX
    assert z0["param_shapes"] == z0["mu_shapes"] == whole and z0["zero_dims"] is None
    for z in (z1, z2):
        assert z["param_shapes"] == whole and z["mu_shapes"] == half
        assert z["fsdp_dims"] == [None] * 3 and z["zero_dims"] == [0, 0, 0]
    assert z3["param_shapes"] == z3["mu_shapes"] == half and z3["fsdp_dims"] == [0, 0, 0]
    assert z3["resident_bytes"] * 2 == z0["resident_bytes"]  # min_weight_size=1: all split
    acc1 = _zero("z2_accum")
    assert acc1["accum_shapes"] == half  # ZeRO-2 splits the accumulation buffers


@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_get_state_dict_gathers_by_the_layout_it_is_handed(stage):
    """A TrainState gathers by its own dims, its params tree by the prepared layout, and
    a tree of other shapes (whole params where ZeRO-3 splits them) raises."""
    got = _zero(f"z{stage}")
    assert got["state_dict_of_state_equal"]
    assert got["whole_params_refused"] == (stage == 3)


def test_zero2_with_accumulation_matches_jax():
    losses, _, params = _jax_train(2, steps=2, accum=2)
    got = _zero("z2_accum")
    np.testing.assert_allclose(got["losses"], losses, rtol=2e-5)
    np.testing.assert_allclose(got["losses"], _zero("z0_accum")["losses"], rtol=2e-5)
    for k, v in params.items():
        np.testing.assert_allclose(got["params"][k], v, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("stage", [1, 2, 3])
def test_fused_adamw_on_shards_with_clipping_matches_jax(stage):
    losses, norms, params = _jax_train(stage, fused=True, clip=0.2)
    assert min(norms) > 0.2  # every step clips
    got = _zero(f"z{stage}_fused")
    np.testing.assert_allclose(got["losses"], losses, rtol=2e-5)
    np.testing.assert_allclose(got["grad_norms"], norms, rtol=1e-5)
    for k, v in params.items():
        np.testing.assert_allclose(got["params"][k], v, rtol=1e-5, atol=1e-6)


def test_zero3_offload_with_accumulation_matches_jax():
    losses, _, params = _jax_train(0, steps=2, accum=2, fused=True)
    got = _zero("z3_offload_accum")
    np.testing.assert_allclose(got["losses"], losses, rtol=2e-5)
    for k, v in params.items():
        np.testing.assert_allclose(got["params"][k], v, rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------------------------ cpu_offload
def _port_offload(opt: str, accum: int, steps: int, offload: bool = True):
    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()
    params, batch = _make_problem()
    acc = Accelerator(device="cpu", gradient_accumulation_steps=accum,
                      fsdp_plugin=FullyShardedDataParallelPlugin(
                          zero_stage=0, cpu_offload=offload, min_weight_size=1))
    tx = tfo.fused_adamw(1e-2) if opt == "fused" else optim.adamw(1e-2)
    state = acc.create_train_state({k: torch.tensor(v) for k, v in params.items()}, tx)

    def loss_fn(p, b):
        h = torch.tanh(b["x"] @ p["w1"] + p["b1"])
        return torch.mean((h @ p["w2"] - b["y"]) ** 2)

    step = acc.build_train_step(loss_fn)
    losses = []
    for _ in range(steps * accum):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    return losses, state


@pytest.mark.parametrize("opt", ["adamw", "fused"])
@pytest.mark.parametrize("accum", [1, 2])
def test_cpu_offload_matches_jax(monkeypatch, opt, accum):
    monkeypatch.setattr(tfo, "OFFLOAD_CHUNK_ELEMS", 1024)  # several chunks, leaves cut
    steps = 3 if accum == 1 else 2
    want = _jax_train(0, steps=steps, accum=accum, fused=opt == "fused")
    losses, state = _port_offload(opt, accum, steps)
    np.testing.assert_allclose(losses, want[0], rtol=2e-5)
    for k, v in want[2].items():
        np.testing.assert_allclose(state.params[k].numpy(), v, rtol=1e-5, atol=1e-6)
    if opt == "fused":
        assert tfo.OFFLOAD_STATS["chunks"] == 2  # 2048 + 32 + 256 elements in 1024s
        assert tfo.OFFLOAD_STATS["whole_leaves"] == 2  # b1 and w2 are not 1024-multiples
        _, plain = _port_offload(opt, accum, steps, offload=False)
        for a, b in zip(jax.tree_util.tree_leaves((state.params, state.opt_state.mu,
                                                   state.opt_state.nu)),
                        jax.tree_util.tree_leaves((plain.params, plain.opt_state.mu,
                                                   plain.opt_state.nu))):
            assert torch.equal(a, b)  # the chunked stream gives the whole apply's bits


def test_offload_chunks_cover_every_element_once():
    sizes = [3072, 1024, 5120, 2048]
    plan = tfo.offload_chunks(sizes, 2048)
    covered = [np.zeros(n, np.int32) for n in sizes]
    for chunk in plan:
        assert sum(n for _, _, n, _ in chunk) <= 2048
        offsets = [off for _, _, _, off in chunk]
        assert offsets == sorted(offsets) and offsets[0] == 0
        for i, a, n, off in chunk:
            assert a % 1024 == n % 1024 == off % 1024 == 0
            covered[i][a:a + n] += 1
    assert all((c == 1).all() for c in covered) and len(plan) == 6


# ---------------------------------------------------------------- tiny llama at ZeRO-3
def _jax_llama_train(cfg_kw, batches, mesh_kw, specs=False):
    for cls in (JAS, JGS, JPS):
        cls._reset_state()
    cfg = _jcfg(cfg_kw)
    acc = JAccelerator(mesh_config=JMeshConfig(**mesh_kw),
                       fsdp_plugin=JPlugin(zero_stage=3))
    seed = 5 if specs else 2
    state = acc.create_train_state(jax.tree.map(jnp.asarray, _np_llama(cfg_kw, seed)),
                                   jfo.fused_adamw(LR),
                                   partition_specs=jl.partition_specs(cfg) if specs else None)
    step = acc.build_train_step(lambda p, b: jl.loss_fn(p, b, cfg), max_grad_norm=CLIP)
    out = {"losses": [], "grad_norms": [], "params": []}
    for batch in batches:
        state, metrics = step(state, jax.tree.map(jnp.asarray, batch))
        out["losses"].append(float(metrics["loss"]))
        out["grad_norms"].append(float(metrics["grad_norm"]))
        out["params"].append(jax.tree.map(np.array, state.params))
    for cls in (JAS, JGS, JPS):
        cls._reset_state()
    return out


def _params_close(got_tree, want_tree):
    g = np.concatenate([np.ravel(x) for x in jax.tree_util.tree_leaves(got_tree)])
    w = np.concatenate([np.ravel(x) for x in jax.tree_util.tree_leaves(want_tree)])
    diff = np.abs(g - w)
    assert diff.max() <= LR / 2
    assert np.mean(diff <= 2e-6 + 1e-5 * np.abs(w)) >= 0.999


def test_llama_zero3_packed_matches_jax():
    want = _jax_llama_train(_llama_cfg_kw(), _packed_batches(3, 8, 11), {"dp": 4, "fsdp": 2})
    assert min(want["grad_norms"]) > 10 * CLIP  # every step clips
    for rank in _ranks_2():
        got = rank[1]
        assert got["distributed_type"] == "FSDP"
        assert got["fsdp_dims"].count(None) < len(got["fsdp_dims"])  # norms stay whole
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
        np.testing.assert_allclose(got["grad_norms"], want["grad_norms"], rtol=1e-5)
        for g, w in zip(got["params"], want["params"]):
            _params_close(g, w)
        assert got["stats"]["all_gather"] > 0 and got["stats"]["reduce_scatter"] > 0


def test_llama_zero3_layer_gather_equals_whole_tree_gather():
    ranks = _ranks_2()
    for rank in ranks:
        lazy, whole = rank[1], rank[2]
        assert lazy["losses"] == whole["losses"]
        assert lazy["grad_norms"] == whole["grad_norms"]
        for a, b in zip(jax.tree_util.tree_leaves(lazy["params"]),
                        jax.tree_util.tree_leaves(whole["params"])):
            assert np.array_equal(a, b)
        # Each layer gathers inside its remat unit, so the backward's recompute gathers
        # its leaves again: more gathers than the whole tree's once a step.
        assert lazy["stats"]["all_gather"] > whole["stats"]["all_gather"]
        assert lazy["stats"]["reduce_scatter"] == whole["stats"]["reduce_scatter"]
    assert ranks[0][1]["resident_bytes"] == ranks[1][1]["resident_bytes"]


def _norm_spec(spec):
    entries = list(spec)[1:] if spec and spec[0] == "P" else list(spec)
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(tuple(e) if isinstance(e, (list, tuple)) else e for e in entries)


def test_dp1_fsdp2_tp2_specs_and_losses_match_jax():
    cfg = _jcfg(TP_FSDP_CFG)
    mesh = jbuild_mesh(JMeshConfig(dp=2, fsdp=2, tp=2))
    placed = japply_tp(jax.tree.map(jnp.asarray, _np_llama(TP_FSDP_CFG, 5)), mesh,
                       specs=jl.partition_specs(cfg), fsdp_plugin=JPlugin(zero_stage=3))
    want_specs = [_norm_spec(x.sharding.spec) for x in jax.tree_util.tree_leaves(placed)]
    want = _jax_llama_train(TP_FSDP_CFG, _packed_batches(2, 4, 31),
                            {"dp": 2, "fsdp": 2, "tp": 2}, specs=True)
    ranks = _ranks_4()
    assert len(ranks) == 4
    for rank in ranks:
        got = rank[0]
        specs = [_norm_spec(s) for s in jax.tree_util.tree_leaves(
            got["specs"], is_leaf=lambda x: isinstance(x, tuple) and x[:1] == ("P",))]
        assert specs == want_specs
        assert any("fsdp" in str(s) and "tp" in str(s) for s in specs)
        assert got["distributed_type"] == "HYBRID"
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
        np.testing.assert_allclose(got["grad_norms"], want["grad_norms"], rtol=1e-5)
        for g, w in zip(got["params"], want["params"]):
            _params_close(g, w)


@pytest.mark.parametrize("case,job", [("lora", 3), ("fp8", 4)])
def test_lora_and_fp8_under_zero3_match_one_process(case, job):
    cfg_kw = LORA_KW if case == "lora" else FP8_KW
    want = _one_process_fp8_lora(cfg_kw, _packed_batches(2, 4, 21))
    for rank in _ranks_2():
        got = rank[job]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
        for g, w in zip(got["params"], want["params"]):
            _params_close(g, w)
        if case == "lora":
            assert got["adapters_moved"] and got["base_unchanged"]
        else:
            np.testing.assert_allclose(got["history"], want["history"], rtol=1e-5)
