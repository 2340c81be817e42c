"""The port's nested-structure operations and host-level collectives
(``accelerate_tpu_torch/utils/operations.py``) against the JAX package's
``utils/operations``, on the CPU.

Mirrors ``tests/test_operations.py``: the structural walk, ``send_to_device`` (with
``skip_keys`` at any level), batch-size discovery, structure round trips, padding,
concatenation, slicing and fp32 conversion, each held equal to JAX's result on the
same numpy inputs. The collectives, which JAX runs across its 8 virtual devices, run
here as 2 gloo ranks (``notebook_launcher``, one spawn for the whole file): gather,
gather_object, reduce, broadcast, broadcast_object_list, pad_across_processes, debug
mode's shape check, the ``DataLoaderDispatcher`` (rank 0 reads and broadcasts), and
``Accelerator.prepare``'s loader under dp=2 with ``gather_for_metrics``.
"""

import collections
import functools

import numpy as np
import pytest
import torch

import torch_tp_ranks
from accelerate_tpu.utils import operations as jops
from accelerate_tpu_torch.launchers import notebook_launcher
from accelerate_tpu_torch.utils import operations as ops

Point = collections.namedtuple("Point", ["x", "y"])


def test_recursively_apply_structures():
    data = {"a": np.ones(2), "b": [torch.zeros(3), (np.ones(1),)], "c": "keep",
            "p": Point(torch.ones(2), 5)}
    out = ops.recursively_apply(lambda t: t + 1, data)
    assert isinstance(out["p"], Point) and out["p"].y == 5 and out["c"] == "keep"
    np.testing.assert_array_equal(out["a"], np.full(2, 2.0))
    assert torch.equal(out["b"][0], torch.ones(3))
    assert torch.equal(out["p"].x, torch.full((2,), 2.0))
    with pytest.raises(TypeError):
        ops.recursively_apply(lambda t: t, {"c": "keep"}, error_on_other_type=True)


def test_honor_type_namedtuple():
    assert ops.honor_type(Point(1, 2), iter([3, 4])) == Point(3, 4)


def test_send_to_device_converts_and_skips_keys_at_every_level():
    batch = {"outer": {"meta": np.ones(3), "x": np.ones((8, 2))}, "y": torch.ones(8),
             "n": 3}
    out = ops.send_to_device(batch, "cpu", skip_keys="meta")
    assert isinstance(out["outer"]["meta"], np.ndarray)
    assert torch.is_tensor(out["outer"]["x"]) and out["outer"]["x"].dtype == torch.float64
    assert torch.is_tensor(out["y"]) and out["n"] == 3
    out = ops.send_to_device(batch, torch.device("cpu"), skip_keys=["outer"])
    assert out["outer"] is batch["outer"]


@pytest.mark.parametrize("data", [
    {"a": [np.ones((4, 2))]}, [np.float64(1.0), np.ones((2,))], ["str"],
    (np.ones(()), {"b": np.ones((3, 1))})], ids=["nested", "scalar_first", "none", "0d_first"])
def test_find_batch_size_matches_jax(data):
    assert ops.find_batch_size(data) == jops.find_batch_size(data)
    as_torch = ops.recursively_apply(torch.from_numpy, data,
                                     test_type=lambda x: isinstance(x, np.ndarray))
    assert ops.find_batch_size(as_torch) == jops.find_batch_size(data)


def test_gather_reduce_broadcast_single_process_are_identities():
    x = torch.arange(6.0).reshape(2, 3)
    assert ops.gather({"t": x})["t"] is x
    assert ops.gather_object([{"k": 1}]) == [{"k": 1}]
    assert torch.equal(ops.reduce(x, "sum", scale=2.0), x * 2)
    assert torch.equal(ops.broadcast({"x": x})["x"], x)
    assert ops.broadcast_object_list([1, "two", {"three": 3}]) == [1, "two", {"three": 3}]
    assert ops.pad_across_processes(x) is x


def test_pad_input_tensors_matches_jax():
    x = np.arange(6, dtype=np.float32).reshape(6, 1)
    for batch, procs in ((6, 4), (6, 3), (5, 2)):
        want = jops.pad_input_tensors(x[:batch], batch_size=batch, num_processes=procs)
        np.testing.assert_array_equal(
            ops.pad_input_tensors(x[:batch], batch_size=batch, num_processes=procs), want)
        got = ops.pad_input_tensors(torch.from_numpy(x[:batch]), batch, procs)
        np.testing.assert_array_equal(got.numpy(), want)
    empty = np.zeros((0, 3), dtype=np.float32)
    assert ops.pad_input_tensors(empty, batch_size=6, num_processes=4).shape == (0, 3)


def test_concatenate_matches_jax():
    a = {"x": np.ones((2, 3)), "y": [np.zeros((2,))]}
    b = {"x": np.ones((4, 3)), "y": [np.ones((1,))]}
    out, want = ops.concatenate([a, b]), jops.concatenate([a, b])
    np.testing.assert_array_equal(out["x"], want["x"])
    np.testing.assert_array_equal(out["y"][0], want["y"][0])
    mixed = ops.concatenate([{"x": torch.ones(2)}, {"x": np.zeros(1, np.float32)}])
    assert torch.equal(mixed["x"], torch.tensor([1.0, 1.0, 0.0]))
    with pytest.raises(TypeError):
        ops.concatenate(["a", "b"])


def test_slice_tensors():
    out = ops.slice_tensors({"x": torch.arange(10), "n": np.arange(10)}, slice(2, 5))
    assert torch.equal(out["x"], torch.arange(2, 5))
    np.testing.assert_array_equal(out["n"], jops.slice_tensors({"n": np.arange(10)},
                                                               slice(2, 5))["n"])


def test_convert_to_fp32():
    data = {"h": torch.ones(2, dtype=torch.bfloat16), "f16": torch.ones(2, dtype=torch.float16),
            "f": torch.ones(2), "i": torch.ones(2, dtype=torch.int32)}
    out = ops.convert_to_fp32(data)
    assert [out[k].dtype for k in ("h", "f16", "f", "i")] == [torch.float32] * 3 + [torch.int32]


def test_get_data_structure_and_initialize():
    info = ops.get_data_structure({"x": np.ones((2, 3), dtype=np.float32)})
    assert info["x"].shape == (2, 3) and info["x"].dtype == torch.float32
    zeros = ops.initialize_tensors(info)
    assert torch.equal(zeros["x"], torch.zeros((2, 3)))
    assert ops.get_shape({"x": torch.ones(2, 3)}) == jops.get_shape({"x": np.ones((2, 3))})


def test_listify_matches_jax():
    assert ops.listify({"x": torch.arange(3), "y": np.arange(2)}) == {"x": [0, 1, 2],
                                                                      "y": [0, 1]}
    assert ops.listify({"x": np.arange(3)}) == jops.listify({"x": np.arange(3)})


# ------------------------------------------------------------------ 2 gloo ranks (one spawn)
DISPATCH_CASES = {"no_split_n11": (11, 2, False), "split_n10": (10, 4, True),
                  "no_split_n8": (8, 2, False)}


@functools.lru_cache(maxsize=None)
def _two_ranks():
    jobs = [("collectives", (3,))]
    jobs += [("dispatched_batches", args) for args in DISPATCH_CASES.values()]
    jobs += [("accelerator_loader", (10, 4, {"dp": 2}))]
    return notebook_launcher(torch_tp_ranks.run_all, (jobs,), 2, device="cpu", backend="gloo",
                             timeout_s=120)


def test_gather_two_ranks():
    r0, r1 = (r[0] for r in _two_ranks())
    for r in (r0, r1):
        np.testing.assert_array_equal(r["gather"]["x"], np.concatenate([r0["x"], r1["x"]]))
        np.testing.assert_array_equal(r["gather"]["s"], [0.0, 1.0])
        assert r["gather_object"] == [{"rank": 0}, {"rank": 1}]


def test_reduce_two_ranks():
    r0, r1 = (r[0] for r in _two_ranks())
    total = r0["x"] + r1["x"]
    for r in (r0, r1):
        np.testing.assert_allclose(r["reduce_sum"], total, rtol=1e-6)
        np.testing.assert_allclose(r["reduce_mean"], total / 2, rtol=1e-6)
        np.testing.assert_allclose(r["reduce_scaled"], total * 0.5, rtol=1e-6)


def test_broadcast_two_ranks():
    r0, r1 = (r[0] for r in _two_ranks())
    for r in (r0, r1):
        np.testing.assert_array_equal(r["broadcast"], r1["x"])
        assert r["objects"] == [1, "from 1"]


def test_pad_across_processes_two_ranks():
    r0, r1 = (r[0] for r in _two_ranks())
    np.testing.assert_array_equal(r0["pad"], [[1, 1], [0, 0]])
    np.testing.assert_array_equal(r1["pad"], [[2, 2], [2, 2]])
    np.testing.assert_array_equal(r0["pad_first"], [[-1, 1, 1]] * 2)
    np.testing.assert_array_equal(r1["pad_first"], [[2, 2, 2]] * 2)


def test_set_seed_and_rng_sync_two_ranks():
    """``set_seed(device_specific=True)`` gives each rank its own stream; after
    ``synchronize_rng_states`` both ranks draw rank 0's numbers."""
    r0, r1 = (r[0] for r in _two_ranks())
    assert r0["own_draw"] != r1["own_draw"]
    assert r0["synced_draws"] == r1["synced_draws"]


def test_set_seed_single_process():
    import random

    from accelerate_tpu_torch.utils.random import set_seed, synchronize_rng_states

    draws = []
    for _ in range(2):
        assert set_seed(7, device_specific=True) == 7  # process index 0
        draws.append((random.random(), float(np.random.rand()), float(torch.rand(1))))
    assert draws[0] == draws[1]
    synchronize_rng_states(["python", "numpy", "torch", "generator"])  # one process: no-op


def test_debug_mode_refuses_mismatched_shapes():
    for r in (r[0] for r in _two_ranks()):
        assert "Mismatch in operands for `gather`" in r["debug_mode"]


@pytest.mark.parametrize("case", list(DISPATCH_CASES))
def test_dispatcher_two_ranks(case):
    """Rank 0 reads every batch; each rank gets its slice, the last global batch padded
    with its first rows (the remainder says how many are real): JAX's rule."""
    n, bs, split = DISPATCH_CASES[case]
    r0, r1 = (r[1 + list(DISPATCH_CASES).index(case)] for r in _two_ranks())
    rows = np.arange(n, dtype=np.float32)
    global_bs = bs if split else 2 * bs
    merged = np.concatenate([np.concatenate([a, b]) for a, b in zip(r0["x"], r1["x"])])
    want = []
    for start in range(0, n, global_bs):
        g = rows[start:start + global_bs]
        pad = (-len(g)) % 2
        want.append(np.concatenate([g, g[:pad]]))
    np.testing.assert_array_equal(merged, np.concatenate(want))
    assert r0["len"] == r1["len"] == len(r0["x"]) == len(want)
    assert r0["end"] == r1["end"] == [False] * (len(want) - 1) + [True]
    last = n - (len(want) - 1) * global_bs
    assert r0["remainder"][-1] == (last if last % 2 else -1)
    for r in (r0, r1):
        np.testing.assert_array_equal(np.concatenate(r["y"])[:, 0], np.concatenate(r["x"]))


def test_accelerator_loader_two_batch_ranks():
    """dp=2: each rank loads its shard of every global batch (BatchSamplerShard), the
    shards are gathered into the global batch on both ranks, and ``gather_for_metrics``
    of each rank's slice gives the global batch back, trimmed to the real samples at
    the end (JAX's ``remainder`` rule)."""
    r0, r1 = (r[-1] for r in _two_ranks())
    assert len(r0["batches"]) == len(r1["batches"]) == 2
    # 10 rows, 4 a rank: the second global batch holds 2 real rows of each shard's 4.
    want = [np.array([0, 1, 2, 3, 4, 5, 6, 7], np.float32),
            np.array([8, 9, 0, 1, 2, 3, 4, 5], np.float32)]
    for r in (r0, r1):
        for got, w in zip(r["batches"], want, strict=True):
            np.testing.assert_array_equal(got, w)
        np.testing.assert_array_equal(r["metrics"][0], want[0])
        np.testing.assert_array_equal(r["metrics"][1], want[1][:2])
        assert r["reduce"] == 1.0
