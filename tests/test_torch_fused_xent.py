"""The port's fused cross-entropy against the JAX package's, on the CPU.

The JAX side runs the Pallas kernels in interpret mode with ``block_t=32, block_v=128``
(as ``tests/test_fused_xent`` does), at T=70, D=64, V=300, so neither axis is a block
multiple; the port's raw entry points run their plain versions on CPU tensors. The
same seeded numpy inputs go to both: nll (softcap 0 and 30), dx and dw of
``sum(nll * cot)`` for a random cotangent (``jax.grad`` of the Pallas version against
torch autograd through the port's ``autograd.Function``), bf16 inputs, and targets of
-1. Then ``llama.loss_fn`` with ``loss_impl="fused"`` against the JAX ``loss_fn`` on
``tiny`` (vocab 300, fp32, with a mask), untied and Gemma-style (tied head,
``final_softcap=20``).

The forward's tile schedule (per-tile partials and the combine's merge,
``PLAIN_FWD_STEPS``) is held against the same Pallas forward at tiles of 128, 256 and
512 columns.

Tolerances: fp32 nll rtol 2e-5 / atol 2e-6, gradients rtol 3e-5 / atol 3e-6 (the two
sides sum over D and V in other orders and tiles); bf16 2e-2; the model's loss rtol
1e-5 and gradients rtol 5e-5 (atol 5e-6).
"""

import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from accelerate_tpu.models import llama as jl
from accelerate_tpu.ops import fused_xent as jfx
from accelerate_tpu_torch.models import llama as tl
from accelerate_tpu_torch.models.convert import params_from_jax, params_to_numpy
from accelerate_tpu_torch.ops import fused_xent as tfx

T, D, V = 70, 64, 300


def _data(seed=0, ignore=False):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(T, D)) * 0.3).astype(np.float32)
    w = (rng.normal(size=(D, V)) * 0.1).astype(np.float32)
    t = rng.integers(0, V, size=(T,)).astype(np.int32)
    t[-1] = V - 1  # a target in the last, ragged vocab block
    if ignore:
        t[::5] = -1
    cot = rng.normal(size=(T,)).astype(np.float32)
    return x, w, t, cot


def _jax_nll(x, w, t, softcap):
    return jfx.fused_cross_entropy(x, w, t, softcap=softcap, block_t=32, block_v=128,
                                   interpret=True)


@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_nll_matches_jax(softcap):
    x, w, t, _ = _data()
    want = np.asarray(_jax_nll(jnp.asarray(x), jnp.asarray(w), jnp.asarray(t), softcap))
    nll, lse = tfx._fwd(torch.tensor(x), torch.tensor(w), torch.tensor(t), softcap)
    assert nll.dtype == lse.dtype == torch.float32
    np.testing.assert_allclose(nll.numpy(), want, rtol=2e-5, atol=2e-6)
    assert torch.all(nll >= 0)  # -log p


@pytest.mark.parametrize("ignore", [False, True], ids=["targets", "ignored_targets"])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_grads_match_jax(softcap, ignore):
    x, w, t, cot = _data(seed=1, ignore=ignore)

    def jax_loss(x, w):
        return jnp.sum(_jax_nll(x, w, jnp.asarray(t), softcap) * cot)

    jdx, jdw = jax.grad(jax_loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    tx, tw = (torch.tensor(a).requires_grad_() for a in (x, w))
    nll = tfx.fused_cross_entropy(tx, tw, torch.tensor(t), softcap=softcap)
    (nll * torch.tensor(cot)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), rtol=3e-5, atol=3e-6)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jdw), rtol=3e-5, atol=3e-6)
    if ignore:  # an ignored target's nll is its lse
        _, lse = tfx._fwd(tx.detach(), tw.detach(), torch.tensor(t), softcap)
        assert torch.equal(nll.detach()[::5], lse[::5])


def test_bf16_inputs_match_jax():
    x, w, t, cot = _data(seed=2)
    jx, jw = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    want = np.asarray(_jax_nll(jx, jw, jnp.asarray(t), 0.0))
    jdx, jdw = jax.grad(lambda a, b: jnp.sum(_jax_nll(a, b, jnp.asarray(t), 0.0) * cot),
                        argnums=(0, 1))(jx, jw)
    tx = torch.tensor(np.asarray(jx.astype(jnp.float32))).bfloat16().requires_grad_()
    tw = torch.tensor(np.asarray(jw.astype(jnp.float32))).bfloat16().requires_grad_()
    nll = tfx.fused_cross_entropy(tx, tw, torch.tensor(t))
    (nll * torch.tensor(cot)).sum().backward()
    assert tx.grad.dtype == tw.grad.dtype == torch.bfloat16
    np.testing.assert_allclose(nll.detach().numpy(), want, rtol=2e-2, atol=2e-2)
    for got, ref in ((tx.grad, jdx), (tw.grad, jdw)):
        got, ref = got.float().numpy(), np.asarray(ref, np.float32)
        assert np.abs(got - ref).max() <= 2e-2 * max(1.0, np.abs(ref).max())


def test_raw_backward_is_the_plain_versions():
    """``_bwd`` on CPU tensors is the two plain versions; d is rounded to w's type for
    dx and to x's type for dw (fp32 here, so the values are those of autograd)."""
    x, w, t, cot = (torch.tensor(a) for a in _data(seed=3))
    _, lse = tfx._fwd(x, w, t, 20.0)
    dx, dw = tfx._bwd(x, w, t, lse, cot, 20.0)
    assert torch.equal(dx, tfx.fused_xent_dx_reference(x, w, t, lse, cot, 20.0))
    assert torch.equal(dw, tfx.fused_xent_dw_reference(x, w, t, lse, cot, 20.0))
    xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
    (tfx.fused_xent_reference(xr, wr, t, 20.0)[0] * cot).sum().backward()
    torch.testing.assert_close(dx, xr.grad, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(dw, wr.grad, rtol=1e-5, atol=1e-6)


# The bf16 backward's slab schedule (``_bwd_slabs``) run on the CPU with the plain
# per-slab steps: slab widths that leave a ragged last slab (300 = 128 + 128 + 44) or one
# slab, softcap, ignored targets, bf16 and a tied head (w the transposed view of an
# embedding). Against JAX's VJP (interpret mode) at the tolerances of the tests above,
# and against the whole-matrix plain versions: fp32 within rtol 1e-5 / atol 1e-6 (the
# slabs add dx's fp32 partial sums in another order), bf16 within one bf16 step
# (d takes the same rounding; dx's fp32 sum may round to the neighbouring value).
SLAB_CASES = {
    "fp32_ragged": dict(dtype=torch.float32, softcap=0.0, ignore=False, tied=False, slab=128),
    "fp32_softcap_ignored": dict(dtype=torch.float32, softcap=30.0, ignore=True, tied=False,
                                 slab=128),
    "fp32_one_slab": dict(dtype=torch.float32, softcap=0.0, ignore=False, tied=False, slab=512),
    "bf16_ragged": dict(dtype=torch.bfloat16, softcap=0.0, ignore=True, tied=False, slab=128),
    "tied_head_softcap": dict(dtype=torch.float32, softcap=20.0, ignore=False, tied=True,
                              slab=256),
    "bf16_tied_head": dict(dtype=torch.bfloat16, softcap=0.0, ignore=False, tied=True,
                           slab=128),
}


@pytest.mark.parametrize("case", list(SLAB_CASES))
def test_bwd_slabs_match_jax(case):
    c = SLAB_CASES[case]
    x, w, t, cot = _data(seed=4, ignore=c["ignore"])
    jdt = jnp.bfloat16 if c["dtype"] == torch.bfloat16 else jnp.float32
    jx = jnp.asarray(x, jdt)
    # A tied head is the transposed view of an embedding [V, D].
    jw = jnp.asarray(np.ascontiguousarray(w.T), jdt).T if c["tied"] else jnp.asarray(w, jdt)
    jdx, jdw = jax.grad(
        lambda a, b: jnp.sum(_jax_nll(a, b, jnp.asarray(t), c["softcap"]) * cot),
        argnums=(0, 1))(jx, jw)
    tx = torch.tensor(np.asarray(jx.astype(jnp.float32))).to(c["dtype"])
    tw = torch.tensor(np.asarray(jw.T.astype(jnp.float32))).to(c["dtype"])
    tw = tw.T if c["tied"] else tw.T.contiguous()
    assert tw.is_contiguous() != c["tied"]
    tt, g = torch.tensor(t), torch.tensor(cot)
    _, lse = tfx._fwd(tx, tw, tt, c["softcap"])
    dx, dw = tfx._bwd_slabs(tx, tw, tt, lse, g, c["softcap"], c["slab"],
                            *tfx.PLAIN_SLAB_STEPS)
    assert dx.dtype == tx.dtype and dw.dtype == tw.dtype
    assert dx.shape == (T, D) and dw.shape == (D, V)
    ref_dx = tfx.fused_xent_dx_reference(tx, tw, tt, lse, g, c["softcap"])
    ref_dw = tfx.fused_xent_dw_reference(tx, tw, tt, lse, g, c["softcap"])
    if c["dtype"] == torch.float32:
        for got, ref in ((dx, jdx), (dw, jdw)):
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=3e-5, atol=3e-6)
        torch.testing.assert_close(dx, ref_dx, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(dw, ref_dw, rtol=1e-5, atol=1e-6)
    else:
        for got, ref in ((dx, jdx), (dw, jdw)):
            got, ref = got.float().numpy(), np.asarray(ref, np.float32)
            assert np.abs(got - ref).max() <= 2e-2 * max(1.0, np.abs(ref).max())
        for got, ref in ((dx, ref_dx), (dw, ref_dw)):
            torch.testing.assert_close(got.float(), ref.float(), rtol=2.0 ** -7, atol=1e-6)


# The forward's schedule run on the CPU with its plain steps (``PLAIN_FWD_STEPS``): each
# row's partial (m, l, tgt) per vocab tile, then the combine's merge in its order. Tiles of
# 128 and 256 (the bf16 kernel's) leave a ragged last tile at V = 300, a tile of 512 is
# wider than V; the last row's target lies in the last, ragged tile and every fifth is
# -1. Against JAX's Pallas forward (interpret mode) at the tolerances of the tests above
# (fp32 rtol 2e-5 / atol 2e-6, bf16 2e-2), and against the whole-matrix plain version
# (rtol 1e-6: fp32 sums in another order).
@functools.lru_cache(maxsize=None)
def _jax_fwd(softcap, bf16):
    x, w, t, _ = _data(seed=5, ignore=True)
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    jx, jw = jnp.asarray(x, jdt), jnp.asarray(w, jdt)
    nll = np.asarray(_jax_nll(jx, jw, jnp.asarray(t), softcap))
    return (np.asarray(jx.astype(jnp.float32)), np.asarray(jw.astype(jnp.float32)), t, nll)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
@pytest.mark.parametrize("tile", [128, 256, 512])
def test_fwd_tiles_match_jax(tile, softcap, dtype):
    x, w, t, want = _jax_fwd(softcap, dtype == torch.bfloat16)
    tx, tw, tt = torch.tensor(x).to(dtype), torch.tensor(w).to(dtype), torch.tensor(t)
    step, merge = tfx.PLAIN_FWD_STEPS
    parts = step(tx, tw, tt, softcap, tile)
    assert all(p.shape == (T, -(-V // tile)) and p.dtype == torch.float32 for p in parts)
    m, l, tgt = merge(*parts)
    lse = m + torch.log(l)
    nll = lse - tgt
    tol = dict(rtol=2e-5, atol=2e-6) if dtype == torch.float32 else dict(rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(nll.numpy(), want, **tol)
    assert torch.equal(nll[::5], lse[::5])  # an ignored target scores nothing
    ref_nll, ref_lse = tfx.fused_xent_reference(tx, tw, tt, softcap)
    torch.testing.assert_close(lse, ref_lse, rtol=1e-6, atol=0)
    torch.testing.assert_close(nll, ref_nll, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("T_, V_, want", [(4096, 128256, 16384), (4096, 64128, 16384),
                                          (70, 300, 512), (1, 5, 256), (65536, 128256, 1024),
                                          (1 << 20, 128256, 256)])
def test_slab_width(T_, V_, want):
    """Slabs are whole 256-column tiles, at most 128 MB of bf16 d, never wider than V
    rounded up to a tile."""
    assert tfx._slab_width(T_, V_) == want


MODEL_CASES = {
    "untied": {},
    "gemma_style_tied_softcap": {"tie_embeddings": True, "final_softcap": 20.0},
}


@pytest.mark.parametrize("case", list(MODEL_CASES))
def test_llama_loss_fused_matches_jax(case):
    kw = {"vocab_size": 300, "remat": False, "loss_impl": "fused", **MODEL_CASES[case]}
    jcfg = dataclasses.replace(jl.CONFIGS["tiny"], dtype=jnp.float32, **kw)
    tcfg = dataclasses.replace(tl.CONFIGS["tiny"], dtype=torch.float32, **kw)
    np_params = jax.tree.map(np.asarray, jl.init_params(jcfg, jax.random.PRNGKey(7)))
    rng = np.random.default_rng(2)
    batch = {"tokens": rng.integers(0, 300, (2, 33)).astype(np.int32),
             "mask": rng.integers(0, 2, (2, 33)).astype(np.float32)}
    batch["mask"][:, 1] = 1.0

    jloss, jgrads = jax.value_and_grad(jl.loss_fn)(
        jax.tree.map(jnp.asarray, np_params), jax.tree.map(jnp.asarray, batch), jcfg)
    params = params_from_jax(np_params, tcfg, device="cpu", master_dtype=torch.float32)
    leaves = [p.requires_grad_() for p in jax.tree_util.tree_leaves(params)]
    tloss = tl.loss_fn(params, {k: torch.tensor(v) for k, v in batch.items()}, tcfg)
    grads = torch.autograd.grad(tloss, leaves)
    grad_tree = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(params), grads)

    np.testing.assert_allclose(float(tloss.detach()), float(jloss), rtol=1e-5)
    got = jax.tree_util.tree_leaves(params_to_numpy(grad_tree))
    want = jax.tree_util.tree_leaves(jax.tree.map(np.asarray, jgrads))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=5e-5, atol=5e-6)
