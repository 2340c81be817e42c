"""The port's AdamW (fused and plain) and SGD against the JAX package's, on the CPU.

Three steps on a small tree — one leaf the kernel layout takes (64 x 32 = 2048
elements, a multiple of 1024) and two it does not — with seeded numpy gradients:

- ``fused_adamw(...).fused_apply`` (a clip scale folded in) against the JAX
  ``fused_adamw(interpret=True).fused_apply``, fp32 and bf16 first moments;
- ``FusedAdamW.update`` against the JAX ``FusedAdamW.update``;
- ``optim.adamw`` / ``optim.sgd`` with ``apply_updates`` against ``optax.adamw`` /
  ``optax.sgd``.

Tolerance: rtol 1e-6, and atol 1e-6 times the leaf's largest magnitude, on params and
moments (the same fp32 operations in the same order; the bias corrections' powers may
differ by one ulp between numpy and XLA). With bf16 first moments the port follows the
JAX package's plain math (``_leaf_xla``, optax's order: ``b1 * m`` rounded to bf16) to
the same tolerance; the JAX Pallas kernel keeps that product in fp32 (its docstring
says so), so against it the first moment may differ by one bf16 ulp (2**-8 of the leaf's
largest magnitude) and params by ``lr * 2**-7`` per step.
"""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from accelerate_tpu.ops import fused_optim as jfo
from accelerate_tpu_torch import optim as topt
from accelerate_tpu_torch.ops import fused_optim as tfo
from accelerate_tpu_torch.utils.tree import tree_leaves

SHAPES = {"w": (64, 32), "b": (7,), "layers": [{"x": (5, 3)}]}
MU = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tree(shapes, rng, scale):
    if isinstance(shapes, dict):
        return {k: _tree(v, rng, scale) for k, v in shapes.items()}
    if isinstance(shapes, list):
        return [_tree(v, rng, scale) for v in shapes]
    return (rng.normal(size=shapes) * scale).astype(np.float32)


def _leaves(tree):
    return jax.tree_util.tree_leaves(tree)  # numpy/jax leaves, sorted dict keys


def _to_torch(tree):
    return jax.tree.map(lambda x: torch.tensor(np.asarray(x)), tree)


def _close(got, want, rtol=1e-6, atol=None):
    got = np.asarray(got.float() if torch.is_tensor(got) else got, np.float32)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    atol = 1e-6 * float(np.abs(want).max()) if atol is None else atol
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _grads(rng, n=3):
    return [_tree(SHAPES, rng, 1e-2) for _ in range(n)]


@pytest.mark.parametrize("use_kernel", [None, False], ids=["jax_kernel", "jax_plain"])
@pytest.mark.parametrize("mu", ["float32", "bfloat16"])
def test_fused_apply_matches_jax(mu, use_kernel):
    jmu, tmu = MU[mu]
    rng = np.random.default_rng(0)
    params = _tree(SHAPES, rng, 0.1)
    lr = 3e-3
    jopt = jfo.fused_adamw(lr, mu_dtype=jmu, use_kernel=use_kernel)
    jopt.interpret = True
    topt_ = tfo.fused_adamw(lr, mu_dtype=tmu)
    jp = jax.tree.map(jnp.asarray, params)
    js = jopt.init(jp)
    tp = _to_torch(params)
    ts = topt_.init(tp)
    grads = _grads(rng)
    for i, g in enumerate(grads):
        scale = 0.5 + 0.25 * i
        jp, js = jopt.fused_apply(jax.tree.map(jnp.asarray, g), js, jp, grad_scale=scale)
        tp, ts = topt_.fused_apply(_to_torch(g), ts, tp, grad_scale=torch.tensor(scale))
    assert ts.count == int(js.count) == 3
    one_rounding = mu == "bfloat16" and use_kernel is None
    for got, want in zip(tree_leaves(tp), _leaves(jp)):
        _close(got, want, atol=len(grads) * lr * 2.0 ** -7 if one_rounding else None)
    for got, want in zip(tree_leaves(ts.mu), _leaves(js.mu)):
        assert got.dtype == tmu
        if one_rounding:
            _close(got, want, rtol=2.0 ** -8, atol=2.0 ** -8 * float(np.abs(want).max()))
        else:
            _close(got, want)
    for got, want in zip(tree_leaves(ts.nu), _leaves(js.nu)):
        _close(got, want)


def test_fused_update_matches_jax():
    rng = np.random.default_rng(1)
    params = _tree(SHAPES, rng, 0.1)
    jopt, topt_ = jfo.fused_adamw(1e-3), tfo.fused_adamw(1e-3)
    jp, tp = jax.tree.map(jnp.asarray, params), _to_torch(params)
    js, ts = jopt.init(jp), topt_.init(tp)
    for g in _grads(rng):
        ju, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, ju)
        tu, ts = topt_.update(_to_torch(g), ts, tp)
        tp = topt.apply_updates(tp, tu)
    for got, want in zip(tree_leaves(tp), _leaves(jp)):
        _close(got, want)


@pytest.mark.parametrize("mu", ["float32", "bfloat16"])
def test_adamw_matches_optax(mu):
    jmu, tmu = MU[mu]
    rng = np.random.default_rng(2)
    params = _tree(SHAPES, rng, 0.1)
    jtx = optax.adamw(2e-3, weight_decay=1e-2, mu_dtype=jmu)
    ttx = topt.adamw(2e-3, weight_decay=1e-2, mu_dtype=tmu)
    jp, tp = jax.tree.map(jnp.asarray, params), _to_torch(params)
    js, ts = jtx.init(jp), ttx.init(tp)
    for g in _grads(rng):
        ju, js = jtx.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, ju)
        tu, ts = ttx.update(_to_torch(g), ts, tp)
        tp = topt.apply_updates(tp, tu)
    for got, want in zip(tree_leaves(tp), _leaves(jp)):
        _close(got, want)
    for got, want in zip(tree_leaves(ts.mu), _leaves(js[0].mu)):
        _close(got, want)


@pytest.mark.parametrize("momentum,nesterov", [(None, False), (0.9, False), (0.9, True)])
def test_sgd_matches_optax(momentum, nesterov):
    rng = np.random.default_rng(3)
    params = _tree(SHAPES, rng, 0.1)
    sched = optax.linear_schedule(0.2, 0.05, transition_steps=3)
    jtx = optax.sgd(sched, momentum=momentum, nesterov=nesterov)
    ttx = topt.sgd(lambda c: float(sched(c)), momentum=momentum, nesterov=nesterov)
    jp, tp = jax.tree.map(jnp.asarray, params), _to_torch(params)
    js, ts = jtx.init(jp), ttx.init(tp)
    for g in _grads(rng):
        ju, js = jtx.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, ju)
        tu, ts = ttx.update(_to_torch(g), ts, tp)
        tp = topt.apply_updates(tp, tu)
    for got, want in zip(tree_leaves(tp), _leaves(jp)):
        _close(got, want)


def test_unported_moments_raise():
    with pytest.raises(NotImplementedError, match="fp8"):
        tfo.fused_adamw(mu_dtype=torch.float8_e4m3fn)
    with pytest.raises(NotImplementedError):
        tfo.fused_adamw(nu_dtype=torch.bfloat16)


def test_kernel_wrapper_cpu_plain_and_cuda_refusal(monkeypatch):
    """CPU leaves take the plain version (no build, no launch counted); the CUDA launcher
    refuses CPU tensors."""
    from accelerate_tpu_torch.ops import _build

    def no_build(*_a, **_k):
        raise AssertionError("the CUDA kernel was built or loaded for CPU tensors")

    monkeypatch.setattr(_build, "build", no_build)
    monkeypatch.setattr(_build, "load", no_build)
    p, m, v, g = (torch.full((1024,), x) for x in (1.0, 0.0, 0.0, 0.5))
    scalars = torch.tensor([1.0, 1e-3, 0.1, 0.001])
    want = tfo.adamw_leaf_reference(p, m, v, g, scalars, b1=0.9, b2=0.999, eps=1e-8, wd=0.0)
    before = tfo.adamw_leaves.launches
    tfo.adamw_leaves([p], [m], [v], [g], scalars, b1=0.9, b2=0.999, eps=1e-8, wd=0.0)
    assert tfo.adamw_leaves.launches == before
    assert all(torch.equal(a, b) for a, b in zip((p, m, v), want))
    with pytest.raises(ValueError, match="must be on CUDA"):
        tfo._adamw_cuda([p], [m], [v], [g], scalars, b1=0.9, b2=0.999, eps=1e-8, wd=0.0)
