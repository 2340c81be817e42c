"""Paged attention of the PyTorch port against the JAX package, on the CPU.

The same numpy inputs (seeded) build a paged pool on both sides through each side's
``write_kv_paged``; the port's ``paged_attention`` (on CPU tensors: its plain version)
is then held against the JAX Pallas kernel in interpret mode and against the JAX
plain reference. Inputs cover GQA groups of 1 and 4, T of 1 and 3, fp32 and bf16,
int8 pools, a sliding window, a softcap, a sentinel entry inside a lane's range and a
never-written lane. The CUDA kernel itself runs only on the card (``chip_smoke.py``).

Tolerances: fp32 1e-5 absolute (the kernel accumulates page by page, the plain
version in one softmax: the sums run in another order); bf16 2e-2 absolute (the plain
version rounds scores to bf16 before the softmax, the kernel keeps them in fp32).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from accelerate_tpu.models import common as jcommon
from accelerate_tpu.ops import paged_attention as jpa
from accelerate_tpu_torch.models import common as tcommon
from accelerate_tpu_torch.ops import paged_attention as tpa

JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
ATOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _case(seed, *, B=4, T=1, H=4, K=2, hd=16, ps=4, MP=6, dtype="float32",
          quantized=False):
    """Seeded inputs on both sides: lane 0 never written, lane 1 with a sentinel page
    inside its range (its slots not valid), the rest random lengths."""
    rng = np.random.default_rng(seed)
    C = MP * ps
    P = B * MP - 2
    lens = rng.integers(T, C + 1, B)
    lens[0] = 0
    lens[1] = max(lens[1], 3 * ps)
    tables = np.full((B, MP), P, np.int32)
    free = list(rng.permutation(P))
    valid = np.zeros((B, C), bool)
    for b, n in enumerate(lens):
        for j in range(-(-n // ps)):
            tables[b, j] = free.pop()
        valid[b, :n] = True
    free.append(tables[1, 1])
    tables[1, 1] = P
    valid[1, ps:2 * ps] = False
    kv = rng.standard_normal((2, B, C, K, hd)).astype(np.float32)
    pos = np.arange(C)
    pages = np.where(valid, tables[:, np.minimum(pos // ps, MP - 1)], P).astype(np.int32)
    offs = np.broadcast_to(pos % ps, (B, C)).astype(np.int32)
    q = rng.standard_normal((B, T, H, hd)).astype(np.float32)
    positions = np.maximum(lens - T, 0).astype(np.int32)

    jpool = jcommon.paged_kv_planes(P, ps, K, hd, JNP[dtype], quantized)
    tpool = tcommon.paged_kv_planes(P, ps, K, hd, TORCH[dtype], quantized)
    for i, name in enumerate("kv"):
        jpool.update(jcommon.write_kv_paged(
            jpool, name, jnp.asarray(kv[i]).astype(JNP[dtype]), jnp.asarray(pages),
            jnp.asarray(offs)))
        tcommon.write_kv_paged(
            tpool, name, torch.from_numpy(kv[i]).to(TORCH[dtype]),
            torch.from_numpy(pages), torch.from_numpy(offs))
    jargs = (jnp.asarray(q).astype(JNP[dtype]), jpool, jnp.asarray(tables),
             jnp.asarray(positions), jnp.asarray(valid))
    targs = (torch.from_numpy(q).to(TORCH[dtype]), tpool, torch.from_numpy(tables),
             torch.from_numpy(positions), torch.from_numpy(valid))
    return jargs, targs, dict(page_size=ps, sm_scale=hd ** -0.5), lens


CASES = [
    # (G, T, dtype, quantized, window, softcap)
    (1, 1, "float32", False, 0, 0.0),
    (4, 1, "float32", False, 0, 0.0),
    (1, 3, "float32", False, 0, 0.0),
    (4, 3, "float32", False, 0, 0.0),
    (4, 1, "bfloat16", False, 0, 0.0),
    (1, 3, "bfloat16", False, 0, 0.0),
    (4, 3, "float32", True, 0, 0.0),
    (4, 1, "bfloat16", True, 0, 0.0),
    (4, 3, "float32", False, 7, 0.0),
    (1, 1, "float32", False, 0, 20.0),
    (4, 3, "float32", False, 5, 30.0),
]


@pytest.mark.parametrize("G,T,dtype,quantized,window,softcap", CASES)
def test_paged_attention_matches_jax(G, T, dtype, quantized, window, softcap):
    K = 2
    jargs, targs, kw, lens = _case(G * 10 + T, T=T, H=K * G, K=K, dtype=dtype,
                                   quantized=quantized)
    kw = dict(kw, window=window, softcap=softcap)
    got = tpa.paged_attention(*targs, **kw)
    assert got.dtype == TORCH[dtype] and tuple(got.shape) == tuple(jargs[0].shape)
    kernel = jpa.paged_attention(*jargs, **kw, interpret=True)
    np.testing.assert_allclose(_np(got), _np(kernel), atol=ATOL[dtype], rtol=0)
    # The JAX plain reference gives a row that sees no key a uniform softmax where
    # both kernels give zeros: compare it on the lanes that were written.
    ref = jpa.paged_attention_reference(*jargs, **kw)
    np.testing.assert_allclose(_np(got)[1:], _np(ref)[1:], atol=ATOL[dtype], rtol=0)
    assert not _np(got)[0].any()  # the never-written lane outputs zeros


@pytest.mark.parametrize("quantized", [False, True])
def test_pool_writes_and_gather_match_jax(quantized):
    """write_kv_paged (sentinel entries dropped, int8 quantized per slot) leaves
    bitwise the JAX pool; gather_pages reads it back bitwise."""
    jargs, targs, kw, _ = _case(3, quantized=quantized)
    for name in targs[1]:
        np.testing.assert_array_equal(_np(targs[1][name]), _np(jargs[1][name]))
    C = jargs[4].shape[1]
    for name in ("k", "v"):
        want = jpa.gather_pages(jargs[1], name, jargs[2], C, jnp.float32)
        got = tpa.gather_pages(targs[1], name, targs[2], C, torch.float32)
        np.testing.assert_array_equal(_np(got), _np(want))
        got_read = tcommon.read_kv_paged(targs[1], name, targs[2], C, torch.float32)
        assert torch.equal(got_read, got)


def test_write_kv_paged_drops_sentinel():
    """A write through the sentinel page id (== P) never lands anywhere."""
    pool = tcommon.paged_kv_planes(2, 4, 1, 4, torch.float32, False)
    out = tcommon.write_kv_paged(pool, "k", torch.ones((1, 1, 1, 4)),
                                 torch.full((1, 1), 2, dtype=torch.int32),
                                 torch.zeros((1, 1), dtype=torch.int32))
    assert float(out["k"].abs().sum()) == 0.0


def test_paged_write_coords_match_jax():
    """Logical → physical write coordinates, past-max_len and unallocated pages routed
    to the sentinel: exactly the JAX routing."""
    rng = np.random.default_rng(5)
    B, MP, ps, max_len, P = 3, 5, 4, 18, 12
    tables = rng.integers(0, P + 1, (B, MP)).astype(np.int32)
    pos_grid = rng.integers(0, max_len + 6, (B, 3)).astype(np.int32)
    jp, jo = jcommon.paged_write_coords(jnp.asarray(tables), jnp.asarray(pos_grid), ps,
                                        max_len, P)
    tp, to = tcommon.paged_write_coords(torch.from_numpy(tables),
                                        torch.from_numpy(pos_grid), ps, max_len, P)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
