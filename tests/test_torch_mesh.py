"""The port's process mesh and tensor-parallel placement against the JAX package's, in
one process (no process group needed).

- ``MeshConfig.resolved_sizes`` gives the JAX sizes, or raises the JAX error with the
  same message, over a table of configs.
- ``llama.partition_specs`` equals the JAX specs leaf for leaf: unstacked and stacked,
  untied and tied, with Gemma-2's post norms and Qwen2's q/k/v biases.
- ``apply_tensor_parallel`` on every rank of a mesh: the shards concatenate back to the
  whole params, the stacked specs apply to the port's per-layer list, and a spec over
  fsdp, sp or pp with more than one rank raises.
- ``Mesh`` lays ranks out row-major over ``(dp, fsdp, tp, sp, pp, ep)`` as the JAX mesh
  lays out devices; ``build_mesh`` in one process needs no group.
- The loss's mesh checks: ``fused_tp`` and ``fused_dp`` raise ``ValueError`` ("mesh
  context") outside one, as ``tests/test_fused_xent.py`` checks for JAX; a one-process
  mesh runs ``fused_tp`` as the single-shard fused CE; a tp-sharded head refuses the
  chunked CE.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accelerate_tpu.models import llama as jl
from accelerate_tpu.parallel import MeshConfig as JMeshConfig
from accelerate_tpu_torch.models import llama as tl
from accelerate_tpu_torch.models.convert import params_from_jax
from accelerate_tpu_torch.parallel import mesh as tm
from accelerate_tpu_torch.parallel import tp as ttp
from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState
from accelerate_tpu_torch.utils.tree import tree_leaves, tree_map


@pytest.fixture(autouse=True)
def _reset_port_singletons():
    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()
    yield
    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()


MESH_TABLE = [
    ({}, 8), ({}, 1), ({"dp": 2, "tp": 4}, 8), ({"dp": -1, "tp": 2}, 8),
    ({"dp": 1, "fsdp": -1, "tp": 2}, 8), ({"dp": 2, "fsdp": 2, "tp": 2}, 8),
    ({"dp": 3}, 8), ({"dp": -1, "fsdp": -1}, 8), ({"dp": -1, "tp": 3}, 8),
    ({"dp": 2, "tp": 2, "sp": 2, "pp": 1, "ep": 1}, 8), ({"tp": 2, "dp": 1}, 4),
]


@pytest.mark.parametrize("kw,n", MESH_TABLE, ids=[f"{kw}-{n}" for kw, n in MESH_TABLE])
def test_resolved_sizes_match_jax(kw, n):
    def outcome(cfg):
        try:
            return cfg.resolved_sizes(n)
        except ValueError as err:
            return f"ValueError: {err}"

    assert outcome(tm.MeshConfig(**kw)) == outcome(JMeshConfig(**kw))


def _as_jax_dict(cfg) -> dict:
    """The port's config as JAX's ``asdict``: the port has no ``dcn_dp`` field, and every
    config it returns is the single-slice layout, JAX's ``dcn_dp=1``."""
    return {**dataclasses.asdict(cfg), "dcn_dp": 1}


def _jax_dict(cfg) -> dict:
    """JAX's ``asdict`` less the fields that are not mesh sizes."""
    return {k: v for k, v in dataclasses.asdict(cfg).items()
            if k not in ("devices", "allow_split_physical_axes")}


def test_mesh_config_from_env(monkeypatch):
    assert tm.MeshConfig.from_env() is None
    assert JMeshConfig.from_env() is None
    monkeypatch.setenv("ACCELERATE_MESH_TP", "2")
    monkeypatch.setenv("ACCELERATE_MESH_DP", "-1")
    assert tm.MeshConfig.from_env() == tm.MeshConfig(dp=-1, tp=2)
    assert _as_jax_dict(tm.MeshConfig.from_env()) == _jax_dict(JMeshConfig.from_env())
    monkeypatch.setenv("ACCELERATE_MESH_DCN_DP", "1")
    assert JMeshConfig.from_env().dcn_dp == 1
    assert _as_jax_dict(tm.MeshConfig.from_env()) == _jax_dict(JMeshConfig.from_env())


@pytest.mark.parametrize("dcn_dp", ["1", "2"])
def test_mesh_config_from_env_dcn_dp_alone(monkeypatch, dcn_dp):
    """Only ``ACCELERATE_MESH_DCN_DP`` set: both sides return a config (not None). At 1
    the port's config is JAX's and builds the mesh of the default config; above 1 the
    port raises rather than build another mesh."""
    monkeypatch.setenv("ACCELERATE_MESH_DCN_DP", dcn_dp)
    want = JMeshConfig.from_env()
    assert want is not None and want.dcn_dp == int(dcn_dp)
    if dcn_dp == "1":
        got = tm.MeshConfig.from_env()
        assert got is not None and _as_jax_dict(got) == _jax_dict(want)
        assert tm.build_mesh(got).shape == tm.build_mesh(tm.MeshConfig()).shape
    else:
        with pytest.raises(NotImplementedError, match="multi-slice"):
            tm.MeshConfig.from_env()


SPEC_CASES = {
    "unstacked": {},
    "stacked": {"scan_layers": True},
    "tied": {"tie_embeddings": True},
    "gemma_post_norm_qwen_bias": {"post_norm": True, "qkv_bias": True, "scan_layers": True},
}


@pytest.mark.parametrize("case", list(SPEC_CASES))
def test_partition_specs_match_jax(case):
    kw = SPEC_CASES[case]
    want = jl.partition_specs(dataclasses.replace(jl.CONFIGS["tiny"], **kw))
    got = tl.partition_specs(dataclasses.replace(tl.CONFIGS["tiny"], **kw))
    w_flat, w_tree = jax.tree_util.tree_flatten(
        want, is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))
    g_flat = tree_leaves(got)
    assert len(g_flat) == len(w_flat)
    assert all(isinstance(s, tm.P) for s in g_flat)
    assert [tuple(s) for s in g_flat] == [tuple(s) for s in w_flat]
    assert isinstance(got["layers"], dict) == bool(kw.get("scan_layers"))


def test_unported_specs_raise():
    with pytest.raises(NotImplementedError):
        tl.partition_specs(tl.CONFIGS["tiny"], pp=True)
    with pytest.raises(NotImplementedError):
        tl.partition_specs(tl.CONFIGS["moe-tiny"])


def _mesh(rank, **sizes):
    full = {name: 1 for name in tm.MESH_AXIS_NAMES}
    full.update(sizes)
    return tm.Mesh(full, rank)


def test_mesh_lays_ranks_out_like_the_jax_mesh():
    sizes = {"dp": 2, "fsdp": 1, "tp": 2, "sp": 1, "pp": 1, "ep": 2}
    layout = np.arange(8).reshape([sizes[a] for a in tm.MESH_AXIS_NAMES])
    for rank in range(8):
        mesh = tm.Mesh(sizes, rank)
        where = {a: int(i) for a, i in zip(tm.MESH_AXIS_NAMES, np.argwhere(layout == rank)[0])}
        assert mesh.coords == where
        assert mesh.axis_index("tp") == where["tp"]
        assert mesh.axis_index(("dp", "tp")) == 2 * where["dp"] + where["tp"]
        assert mesh.ranks_along("tp") == sorted(mesh.ranks_along("tp"))
        assert rank in mesh.ranks_along(("dp", "fsdp"))
    assert tm.mesh_batch_size_divisor(tm.Mesh(sizes, 0)) == 2
    one = tm.build_mesh(tm.MeshConfig())
    assert one.shape == {a: 1 for a in tm.MESH_AXIS_NAMES} and one.group("tp") is None
    with pytest.raises(ValueError, match="multiply to"):
        tm.build_mesh(tm.MeshConfig(dp=1, tp=2))


@pytest.mark.parametrize("stacked", [False, True])
@pytest.mark.parametrize("n", [2, 4])
def test_apply_tensor_parallel_shards_concatenate_back(n, stacked):
    jcfg = dataclasses.replace(jl.CONFIGS["tiny"], dtype=jnp.float32, scan_layers=stacked)
    tcfg = dataclasses.replace(tl.CONFIGS["tiny"], dtype=torch.float32, scan_layers=stacked,
                               n_kv_heads=4)
    np_params = jax.tree.map(np.asarray, jl.init_params(
        dataclasses.replace(jcfg, n_kv_heads=4), jax.random.PRNGKey(0)))
    whole = params_from_jax(np_params, tcfg, device="cpu", master_dtype=torch.float32)
    specs = tl.partition_specs(tcfg)
    shards = [ttp.apply_tensor_parallel(whole, _mesh(r, tp=n), specs) for r in range(n)]

    def joined(leaf, spec, *parts):
        dims = [d for d, e in enumerate(spec) if tm.spec_axes(e)]
        if not dims:
            assert all(p is leaf for p in parts)  # replicated leaves are not copied
            return leaf
        assert all(p.shape[dims[0]] * n == leaf.shape[dims[0]] for p in parts)
        return torch.cat(parts, dim=dims[0])

    flat_specs = tree_leaves(ttp.map_with_specs(lambda leaf, spec: spec, whole, specs))
    for leaf, spec, *parts in zip(tree_leaves(whole), flat_specs,
                                  *(tree_leaves(s) for s in shards)):
        assert torch.equal(joined(leaf, spec, *parts), leaf)
    # From numpy leaves too (params_from_jax(mesh=...) slices before making tensors).
    direct = params_from_jax(np_params, tcfg, device="cpu", master_dtype=torch.float32,
                             mesh=_mesh(1, tp=n), specs=specs)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(direct), tree_leaves(shards[1])))
    assert direct["layers"][0]["wq"].shape == (128, 128 // n)
    assert direct["embed"].shape == (256 // n, 128)


def test_non_tp_sharding_raises():
    specs = {"w": tm.P("fsdp", None)}
    params = {"w": torch.zeros((4, 4))}
    with pytest.raises(NotImplementedError, match="fsdp"):
        ttp.apply_tensor_parallel(params, _mesh(0, fsdp=2), specs)
    assert ttp.apply_tensor_parallel(params, _mesh(0, tp=2), specs)["w"] is params["w"]
    with pytest.raises(ValueError, match="does not split"):
        ttp.apply_tensor_parallel({"w": torch.zeros((3, 4))}, _mesh(0, tp=2),
                                  {"w": tm.P("tp", None)})


def test_plan_registry_and_rules():
    rules = [(r"layers/\d+/wq", tm.P(None, "tp")), (r"embed", tm.P("tp", None))]
    ttp.register_tp_plan("test-rules", ttp.plan_from_rules(rules))
    params = {"embed": torch.zeros((4, 2)), "layers": [{"wq": torch.zeros((2, 4)),
                                                        "ln": torch.zeros(2)}]}
    specs = ttp.get_tp_plan("test-rules")(params)
    assert specs == {"embed": tm.P("tp", None),
                     "layers": [{"wq": tm.P(None, "tp"), "ln": tm.P(None)}]}
    local = ttp.apply_tensor_parallel(params, _mesh(1, tp=2), plan="test-rules")
    assert local["embed"].shape == (2, 2) and local["layers"][0]["wq"].shape == (2, 2)
    with pytest.raises(KeyError, match="No TP plan"):
        ttp.get_tp_plan("missing")
    assert tree_map(lambda s: len(s), specs)["layers"][0]["wq"] == 2  # P is one leaf


def _tiny(**kw):
    jcfg = dataclasses.replace(jl.CONFIGS["tiny"], dtype=jnp.float32, attn_impl="xla")
    tcfg = dataclasses.replace(tl.CONFIGS["tiny"], dtype=torch.float32, attn_impl="xla", **kw)
    params = params_from_jax(jax.tree.map(np.asarray, jl.init_params(jcfg, jax.random.PRNGKey(4))),
                             tcfg, device="cpu", master_dtype=torch.float32)
    batch = {"tokens": torch.tensor(np.random.default_rng(5).integers(0, 256, (2, 17)))}
    return tcfg, params, batch


@pytest.mark.parametrize("impl", ["fused_tp", "fused_dp"])
def test_mesh_losses_need_a_mesh_context(impl):
    cfg, params, batch = _tiny(loss_impl=impl)
    with pytest.raises(ValueError, match="mesh context"):
        tl.loss_fn(params, batch, cfg)


@pytest.mark.parametrize("impl", ["fused_tp", "fused_dp"])
def test_one_process_mesh_runs_the_fused_ce(impl):
    """A one-process mesh: ``fused_tp`` and ``fused_dp`` are the single-shard fused CE."""
    cfg, params, batch = _tiny(loss_impl=impl)
    want = tl.loss_fn(params, batch, dataclasses.replace(cfg, loss_impl="fused"))
    with tm.mesh_context(tm.build_mesh(tm.MeshConfig())):
        got = tl.loss_fn(params, batch, cfg)
    assert tm.current_mesh() is None
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)


def test_tp_sharded_head_refuses_the_chunked_ce(monkeypatch):
    from accelerate_tpu_torch.models import common

    x = torch.zeros((1, 4, 8))
    with tm.mesh_context(_mesh(0, tp=2)):
        monkeypatch.setattr(tm.Mesh, "group", lambda self, axes: "tp-group")
        with pytest.raises(NotImplementedError, match="fused_tp"):
            common.ce_sum_dispatch(x, torch.zeros((8, 6)), torch.zeros((1, 4), dtype=torch.long),
                                   torch.ones((1, 4)), loss_impl="auto", dtype=torch.float32)
