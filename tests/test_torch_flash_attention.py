"""The port's flash attention against the JAX package's, on the CPU.

The JAX side runs the Pallas kernels in interpret mode (as ``tests/test_flash_attention``
does); the port's wrappers run their plain versions on CPU tensors. The same seeded
numpy inputs go to both: the raw forward (o and lse) and the gradients of
``sum(o * w)`` w.r.t. q, k and v (``jax.grad`` against torch autograd through the
port's ``autograd.Function``), over causal and non-causal masks, GQA groups of 1, 2 and
4, a length that is not a block multiple, packed segments with padding (rows that see
no key), a sliding window, a softcap, and nonzero q/kv offsets.

Tolerance: fp32 1e-5 and bf16 3e-2, on max |port - jax| / max(1, max |jax|) (the two
sides take their dots and softmax sums in different orders and tiles).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from accelerate_tpu.ops import flash_attention as jfa
from accelerate_tpu_torch.ops import _build
from accelerate_tpu_torch.ops import flash_attention as tfa

TOL = {"float32": 1e-5, "bfloat16": 3e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}

CASES = {  # name: (shape, kwargs)
    "causal_G2": (dict(H=4, K=2, S=48), {}),
    "noncausal_G1": (dict(H=2, K=2, S=40), {"causal": False}),
    "causal_G4_ragged": (dict(H=8, K=2, S=37), {}),
    "segments_padding": (dict(H=4, K=2, S=48), {"segments": True}),
    "window": (dict(H=4, K=2, S=48), {"window": 9}),
    "softcap": (dict(H=4, K=2, S=48), {"softcap": 5.0}),
}


def _err(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


def _inputs(H, K, S, B=2, hd=32, seed=0, segments=False):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, S, H, hd)).astype(np.float32)
    k = rng.normal(size=(B, S, K, hd)).astype(np.float32)
    v = rng.normal(size=(B, S, K, hd)).astype(np.float32)
    w = rng.normal(size=(B, S, H, hd)).astype(np.float32)
    seg = None
    if segments:
        seg = np.zeros((B, S), np.int32)
        seg[0, :20], seg[0, 20:40] = 1, 2        # two segments, 8 pad slots
        seg[1, :30], seg[1, 30:45] = 1, 2        # row 1: 3 pad slots
    return q, k, v, w, seg


def _round(x, dtype):
    """Inputs rounded to ``dtype`` once, so both sides see the same values."""
    return np.asarray(jnp.asarray(x, JDT[dtype]).astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
def test_flash_forward_and_grads_match_jax(case, dtype):
    shape, kw = CASES[case]
    kw = dict(kw)
    q, k, v, w, seg = _inputs(**shape, segments=kw.pop("segments", False))
    q, k, v = (_round(x, dtype) for x in (q, k, v))
    causal = kw.pop("causal", True)

    def jax_loss(q, k, v):
        o = jfa.flash_attention(q, k, v, causal=causal, interpret=True, block_q=16,
                                block_k=16, segment_ids=None if seg is None else jnp.asarray(seg),
                                **kw)
        return jnp.sum(o.astype(jnp.float32) * w)

    jq, jk, jv = (jnp.asarray(x, JDT[dtype]) for x in (q, k, v))
    o_j = jfa.flash_attention(jq, jk, jv, causal=causal, interpret=True, block_q=16,
                              block_k=16, segment_ids=None if seg is None else jnp.asarray(seg),
                              **kw)
    grads_j = jax.grad(jax_loss, argnums=(0, 1, 2))(jq, jk, jv)

    tq, tk, tv = (torch.tensor(x).to(TDT[dtype]).requires_grad_() for x in (q, k, v))
    o_t = tfa.flash_attention(tq, tk, tv, causal=causal,
                              segment_ids=None if seg is None else torch.tensor(seg), **kw)
    (o_t.float() * torch.tensor(w)).sum().backward()

    tol = TOL[dtype]
    assert o_t.dtype == TDT[dtype] and o_t.shape == q.shape
    assert _err(o_t.float().detach(), np.asarray(o_j, np.float32)) <= tol
    for name, t, j in zip("qkv", (tq, tk, tv), grads_j):
        assert _err(t.grad.float(), np.asarray(j, np.float32)) <= tol, name
    if seg is not None:  # pad rows see no key: zeros, as in the Pallas kernel
        assert torch.all(o_t[0, 40:] == 0) and torch.all(o_t[1, 45:] == 0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_raw_entry_points_with_offsets_match_jax(dtype):
    """The ring's building blocks: q rows at global positions 16.., kv at 0.., T != S;
    o, lse, dq, dk and dv against the JAX raw entry points."""
    rng = np.random.default_rng(5)
    B, H, K, S, T, hd = 1, 4, 2, 32, 48, 32
    q, do = (_round(rng.normal(size=(B, H, S, hd)), dtype) for _ in range(2))
    k, v = (_round(rng.normal(size=(B, K, T, hd)), dtype) for _ in range(2))
    kw = dict(causal=True, sm_scale=hd ** -0.5, q_offset=16, kv_offset=0)
    jargs = [jnp.asarray(x, JDT[dtype]) for x in (q, k, v)]
    jo, jlse = jfa._fwd(*jargs, kw["causal"], kw["sm_scale"], 16, 16, True,
                        q_offset=16, kv_offset=0)
    targs = [torch.tensor(x).to(TDT[dtype]) for x in (q, k, v)]
    to, tlse = tfa._fwd(*targs, **kw)
    tol = TOL[dtype]
    assert _err(to.float(), np.asarray(jo, np.float32)) <= tol
    assert _err(tlse, np.asarray(jlse)) <= tol
    delta = np.asarray(jnp.sum(jnp.asarray(do, jnp.float32) * jo.astype(jnp.float32), -1))
    jdo = jnp.asarray(do, JDT[dtype])
    jdq = jfa._bwd_dq(*jargs, jdo, jlse, jnp.asarray(delta), kw["causal"], kw["sm_scale"],
                      16, 16, True, q_offset=16, kv_offset=0)
    jdk, jdv = jfa._bwd_dkv(*jargs, jdo, jlse, jnp.asarray(delta), kw["causal"],
                            kw["sm_scale"], 16, 16, True, q_offset=16, kv_offset=0)
    tdo = torch.tensor(do).to(TDT[dtype])
    tdq = tfa._bwd_dq(*targs, tdo, torch.tensor(np.asarray(jlse)), torch.tensor(delta), **kw)
    tdk, tdv = tfa._bwd_dkv(*targs, tdo, torch.tensor(np.asarray(jlse)), torch.tensor(delta),
                            **kw)
    for got, want in ((tdq, jdq), (tdk, jdk), (tdv, jdv)):
        assert got.dtype == torch.float32
        assert _err(got, np.asarray(want, np.float32)) <= tol


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    """On CPU tensors the raw entry points never build or launch a kernel and count no
    launch."""
    def no_build(*_a, **_k):
        raise AssertionError("a CUDA kernel was built or loaded for CPU tensors")

    monkeypatch.setattr(_build, "build", no_build)
    monkeypatch.setattr(_build, "load", no_build)
    before = (tfa._fwd.launches, tfa._bwd_dq.launches, tfa._bwd_dkv.launches)
    q, k, v, _, _ = _inputs(H=4, K=2, S=16)
    tq, tk, tv = (torch.tensor(x).transpose(1, 2).requires_grad_() for x in (q, k, v))
    o, lse = tfa._fwd(tq, tk, tv)
    ref_o, ref_lse = tfa.flash_attention_reference(tq, tk, tv)
    assert torch.equal(o, ref_o) and torch.equal(lse, ref_lse)
    tfa.flash_attention(tq.transpose(1, 2), tk.transpose(1, 2), tv.transpose(1, 2)).sum().backward()
    assert (tfa._fwd.launches, tfa._bwd_dq.launches, tfa._bwd_dkv.launches) == before


def test_cuda_launchers_refuse_other_devices():
    """The CUDA launchers refuse CPU tensors, and the raw entry points send tensors that
    are neither CPU nor CUDA to them (which raise) — nothing falls back."""
    q = torch.zeros((1, 2, 8, 32))
    kv = torch.zeros((1, 1, 8, 32))
    with pytest.raises(ValueError, match="must be on CUDA"):
        tfa._fwd_cuda(q, kv, kv, True, None, 0, 0, None, 0, 0.0)
    meta_q, meta_kv = q.to("meta"), kv.to("meta")
    with pytest.raises(ValueError, match="must be on CUDA"):
        tfa._fwd(meta_q, meta_kv, meta_kv)
    with pytest.raises(ValueError, match="must be on CUDA"):
        tfa._bwd_dq(meta_q, meta_kv, meta_kv, meta_q, meta_q[..., 0], meta_q[..., 0])
    with pytest.raises(ValueError, match="must be on CUDA"):
        tfa._bwd_dkv(meta_q, meta_kv, meta_kv, meta_q, meta_q[..., 0], meta_q[..., 0])


def _misaligned(shape):
    """A contiguous bf16 tensor whose base sits 2 bytes past a 16-byte boundary."""
    flat = torch.arange(int(np.prod(shape)) + 8, dtype=torch.float32).to(torch.bfloat16)
    return flat[1:1 + int(np.prod(shape))].view(shape)


LAYOUTS = {  # name: (make [B,H,S,hd] bf16 tensor, read in place)
    "contiguous": (lambda: torch.zeros((2, 4, 40, 32), dtype=torch.bfloat16), True),
    "model_transposed_view": (
        lambda: torch.zeros((2, 40, 4, 32), dtype=torch.bfloat16).transpose(1, 2), True),
    "batch_of_one_any_batch_stride": (
        lambda: torch.zeros(4 * 40 * 32 + 3, dtype=torch.bfloat16).as_strided(
            (1, 4, 40, 32), (3, 40 * 32, 32, 1)), True),
    "odd_row_stride": (
        lambda: torch.zeros((2, 4, 40, 33), dtype=torch.bfloat16)[..., :32], False),
    "base_off_16_bytes": (lambda: _misaligned((2, 4, 40, 32)), False),
    "last_dim_strided": (
        lambda: torch.zeros((2, 4, 40, 64), dtype=torch.bfloat16)[..., ::2], False),
}


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_kernel_layout_reads_tma_eligible_tensors_in_place(name):
    """The CUDA launchers hand the kernels (TMA loads) a tensor in place when its base and
    the strides of its dims of more than one element are on 16 bytes and its last dim is
    contiguous; any other tensor is copied into a fresh contiguous, aligned tensor with the
    same values."""
    make, in_place = LAYOUTS[name]
    x = make()
    x.copy_(torch.randn(x.shape).to(x.dtype))
    assert tfa._tma_ok(x) == in_place
    got = tfa._kernel_layout(x)
    assert (got is x) == in_place
    assert torch.equal(got, x)
    assert tfa._tma_ok(got)
    if not in_place:
        assert got.is_contiguous() and got.data_ptr() % 16 == 0
        assert got.untyped_storage().data_ptr() != x.untyped_storage().data_ptr()
