"""The port's vocab-sharded (tensor-parallel) fused cross-entropy against the JAX
package's, on the CPU.

- Kernel #6's plain version, ``fused_xent_partial_reference``, against the Pallas
  ``_fwd_partial_kernel`` in interpret mode (through ``_launch_fwd``, as
  ``fused_cross_entropy_tp`` launches it): T=60, D=64, a shard 40 wide, ``block_t =
  block_v = 32`` (ragged on both axes), shard-local targets in range, out of range on
  both sides and -1, softcap 0 and 25; m, l and tgt at rtol 1e-5 (atol 1e-6 for scores
  near 0, which the two sides sum in other orders).
- Kernel #6's tile schedule (``PLAIN_FWD_STEPS``: per-tile partials, then the
  combine's merge) against the same Pallas kernel on a shard 300 wide, at tiles of 128,
  256 and 512 columns, fp32 and bf16, softcap 0 and 30.
- The merge of the shards' partials (``lse = m_g + log l_g``) equals
  ``fused_xent_reference`` on the whole head (rtol 1e-6: fp32 sums in another order).
- ``fused_cross_entropy_tp`` over tp=2 and tp=4 gloo ranks (spawned by the port's
  ``notebook_launcher``, one spawn per tp size) against the JAX shard_map setup of
  ``tests/test_fused_xent.py::test_tp_variant_matches_dense`` (T=60, D=64, V=320,
  weights ``m``): nll at rtol 2e-5, dx and the gathered dw at rtol 5e-5 / atol 5e-6,
  that test's tolerances. The ranks load no jax.
- One rank (``group=None``) is the single-shard fused CE, value and gradients.
"""

import functools

import jax
import jax.numpy as jnp
import jax.sharding as shd
import numpy as np
import pytest
import torch

import torch_tp_ranks
from accelerate_tpu.ops import fused_xent as jfx
from accelerate_tpu_torch.launchers import notebook_launcher
from accelerate_tpu_torch.ops import fused_xent as tfx

SOFTCAPS = (0.0, 25.0)


def _shard_data(T=60, D=64, VL=40, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(T, D)) * 0.3).astype(np.float32)
    w = (rng.normal(size=(D, VL)) * 0.1).astype(np.float32)
    t = rng.integers(-VL, 2 * VL, size=(T,)).astype(np.int32)  # in and out of the shard
    t[::7] = -1
    t[1], t[2] = 0, VL - 1  # the first column and the last, ragged block's last column
    return x, w, t


def _pallas_partial(x, w, t, softcap, block=32):
    T, VL = x.shape[0], w.shape[1]
    Tp, Vp = -(-T // block) * block, -(-VL // block) * block
    xp = jnp.pad(jnp.asarray(x), ((0, Tp - T), (0, 0)))
    wp = jnp.pad(jnp.asarray(w), ((0, 0), (0, Vp - VL)))
    tp = jnp.pad(jnp.asarray(t), (0, Tp - T), constant_values=-1).reshape(Tp, 1)
    m, l, tgt = jfx._launch_fwd(jfx._fwd_partial_kernel, 3, xp, wp, tp, vocab=VL,
                                softcap=softcap, block_t=block, block_v=block,
                                interpret=True)
    return tuple(np.asarray(a)[:T, 0] for a in (m, l, tgt))


@pytest.mark.parametrize("softcap", SOFTCAPS)
def test_partial_reference_matches_pallas(softcap):
    x, w, t = _shard_data()
    want = _pallas_partial(x, w, t, softcap)
    got = tfx.fused_xent_partial_reference(torch.tensor(x), torch.tensor(w), torch.tensor(t),
                                           softcap)
    assert all(g.dtype == torch.float32 and g.shape == (60,) for g in got)
    for name, g, ref in zip(("m", "l", "tgt"), got, want):
        np.testing.assert_allclose(g.numpy(), ref, rtol=1e-5, atol=1e-6, err_msg=name)
    off = (t < 0) | (t >= w.shape[1])
    assert off.any() and (~off).any()
    assert np.all(got[2].numpy()[off] == 0.0)  # a target this shard lacks matches nothing
    # The raw entry point takes the plain version on CPU tensors.
    raw = tfx._fwd_partial(torch.tensor(x), torch.tensor(w), torch.tensor(t), softcap)
    assert all(torch.equal(a, b) for a, b in zip(raw, got))


# Kernel #6's schedule run on the CPU with its plain steps (``PLAIN_FWD_STEPS``: each
# row's partial per vocab tile, then the combine's merge) on a shard VL = 300 wide:
# tiles of 128 and 256 (the bf16 kernel's) leave a ragged last tile, 512 is wider than
# the shard; row 2's target is the shard's last column, in the ragged tile; ids of other
# ranks on both sides and -1. Against the Pallas kernel in interpret mode at the
# tolerances above (rtol 1e-5, atol 1e-6).
@functools.lru_cache(maxsize=None)
def _pallas_shard(softcap, bf16):
    x, w, t = _shard_data(VL=300, seed=3)
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    jx, jw = jnp.asarray(x, jdt), jnp.asarray(w, jdt)
    want = _pallas_partial(jx, jw, t, softcap)
    return np.asarray(jx.astype(jnp.float32)), np.asarray(jw.astype(jnp.float32)), t, want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
@pytest.mark.parametrize("tile", [128, 256, 512])
def test_partial_tiles_match_pallas(tile, softcap, dtype):
    x, w, t, want = _pallas_shard(softcap, dtype == torch.bfloat16)
    step, merge = tfx.PLAIN_FWD_STEPS
    got = merge(*step(torch.tensor(x).to(dtype), torch.tensor(w).to(dtype), torch.tensor(t),
                      softcap, tile))
    for name, g, ref in zip(("m", "l", "tgt"), got, want):
        np.testing.assert_allclose(g.numpy(), ref, rtol=1e-5, atol=1e-6, err_msg=name)
    off = (t < 0) | (t >= w.shape[1])
    assert off.any() and (~off).any() and t[2] == w.shape[1] - 1
    assert np.all(got[2].numpy()[off] == 0.0)


@pytest.mark.parametrize("n", [2, 8])
@pytest.mark.parametrize("softcap", SOFTCAPS)
def test_merged_partials_equal_the_whole_head(softcap, n):
    rng = np.random.default_rng(1)
    T, D, V = 60, 64, 320
    x = torch.tensor(rng.normal(size=(T, D)) * 0.3, dtype=torch.float32)
    w = torch.tensor(rng.normal(size=(D, V)) * 0.1, dtype=torch.float32)
    t = torch.tensor(rng.integers(0, V, size=(T,)))
    t[::9] = -1
    vl = V // n
    parts = [tfx.fused_xent_partial_reference(x, w[:, r * vl:(r + 1) * vl], t - r * vl,
                                              softcap) for r in range(n)]
    m, l, tgt = (torch.stack(p) for p in zip(*parts))
    m_g = m.max(0).values
    lse = m_g + torch.log((l * torch.exp(m - m_g)).sum(0))
    nll = lse - tgt.sum(0)
    want_nll, want_lse = tfx.fused_xent_reference(x, w, t, softcap)
    torch.testing.assert_close(lse, want_lse, rtol=1e-6, atol=0)
    torch.testing.assert_close(nll, want_nll, rtol=1e-6, atol=1e-6)


def _full_data(T=60, D=64, V=320):
    rng = np.random.default_rng(6)
    x = (rng.normal(size=(T, D)) * 0.3).astype(np.float32)
    w = (rng.normal(size=(D, V)) * 0.1).astype(np.float32)
    t = rng.integers(0, V, size=(T,)).astype(np.int32)
    m = np.random.default_rng(7).normal(size=(T,)).astype(np.float32)
    return x, w, t, m


def _jax_tp(x, w, t, m, softcap, n):
    mesh = shd.Mesh(np.array(jax.devices()[:n]), ("tp",))

    def loss(x, w):
        def local(xl, wl, tl):
            return jfx.fused_cross_entropy_tp(xl, wl, tl, axis_name="tp", softcap=softcap,
                                              block_t=32, block_v=32)

        nll = jax.shard_map(local, mesh=mesh,
                            in_specs=(shd.PartitionSpec(), shd.PartitionSpec(None, "tp"),
                                      shd.PartitionSpec()),
                            out_specs=shd.PartitionSpec(), check_vma=False)(x, w, jnp.asarray(t))
        return (nll * m).sum(), nll

    with jax.set_mesh(mesh):
        (_, nll), (dx, dw) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
            jnp.asarray(x), jnp.asarray(w))
    return np.asarray(nll), np.asarray(dx), np.asarray(dw)


@functools.lru_cache(maxsize=None)
def _ranks(n):
    x, w, t, m = _full_data()
    return notebook_launcher(torch_tp_ranks.fused_xent_tp, (x, w, t, m, SOFTCAPS), n,
                             device="cpu", backend="gloo", timeout_s=120)


@pytest.mark.parametrize("softcap", SOFTCAPS)
@pytest.mark.parametrize("n", [2, 4])
def test_tp_over_gloo_ranks_matches_jax_shard_map(n, softcap):
    x, w, t, m = _full_data()
    nll, dx, dw = _jax_tp(x, w, t, m, softcap, n)
    ranks = _ranks(n)
    assert len(ranks) == n
    for rank in ranks:
        got = rank[softcap]
        np.testing.assert_allclose(got["nll"], nll, rtol=2e-5)
        np.testing.assert_allclose(got["dx"], dx, rtol=5e-5, atol=5e-6)
        np.testing.assert_allclose(got["dw"], dw, rtol=5e-5, atol=5e-6)
        assert rank["jax_modules"] == []


@pytest.mark.parametrize("softcap", SOFTCAPS)
def test_one_rank_is_the_single_shard_fused_ce(softcap):
    """``group=None``: one rank holds the whole head, and the vocab-sharded path is the
    fused CE itself (no collective), value and gradients."""
    x, w, t, m = _full_data()
    outs = []
    for fn in (lambda a, b: tfx.fused_cross_entropy_tp(a, b, torch.tensor(t), softcap=softcap),
               lambda a, b: tfx.fused_cross_entropy(a, b, torch.tensor(t), softcap=softcap)):
        xt, wt = torch.tensor(x).requires_grad_(), torch.tensor(w).requires_grad_()
        nll = fn(xt, wt)
        (nll * torch.tensor(m)).sum().backward()
        outs.append((nll.detach(), xt.grad, wt.grad))
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
