"""The port's ``ops/quantization.py`` against the JAX package's, on the CPU.

Inputs are seeded numpy arrays handed to both sides. Compared:

- ``quantize_weight`` (int8, int4, nf4; fp32 and bf16 weights, a size that needs a
  padded last block): codes and scales bit for bit; ``dequantize_weight`` equal;
- the int8 ``quant_matmul`` — the port's plain version of the kernel's order
  (``(x_fp32 @ q) * s``, one rounding) against the JAX Pallas kernel in interpret mode:
  fp32 within 1e-5 of each row's largest |y| (the two sum K in another order), bf16 x
  and bf16 out within one bf16 step of |y| (that order differs in the last fp32 bits,
  which may move a rounding by one step); ragged 130×200 @ 200×72 and 3-D x;
- ``dx`` against ``jax.grad`` through the JAX custom VJP (fp32, 1e-5);
- int4/nf4 and ``use_kernel=False`` (dequantize, then multiply) against JAX;
- ``BnbQuantizationConfig`` validation, ``load_and_quantize_model`` (the same leaves
  quantized as JAX, to the same codes, on ``tiny``), ``dequantize_model``;
- ``params_from_jax`` / ``params_to_numpy`` round trips of quantized leaves;
- ``split_plan``, the kernels' launch plan: the route by shape (cluster, ragged, fp32),
  the token tile, the cluster's K ranges in whole tiles at the serving path's shapes and
  at M = 1..128.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from accelerate_tpu.models import llama as jl
from accelerate_tpu.ops import quantization as jq
from accelerate_tpu_torch.models import llama as tl
from accelerate_tpu_torch.models.convert import params_from_jax, params_to_numpy
from accelerate_tpu_torch.ops import quantization as tq


def _normal(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _bf16_np(a):
    return np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _pair(w_np, scheme, dtype="float32", block_size=64):
    """(JAX QuantizedWeight, port QuantizedWeight) of the same weight."""
    jw = jnp.asarray(w_np, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    tw = torch.from_numpy(w_np).to(torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    return (jq.quantize_weight(jw, scheme, block_size),
            tq.quantize_weight(tw, scheme, block_size))


# ------------------------------------------------------------------------ quantize
@pytest.mark.parametrize("scheme", ["int8", "int4", "nf4"])
@pytest.mark.parametrize("shape,dtype", [((64, 32), "float32"), ((5, 7), "float32"),
                                         ((200, 72), "bfloat16")],
                         ids=["64x32", "5x7_padded_block", "200x72_bf16"])
def test_quantize_weight_bit_equal_to_jax(scheme, shape, dtype):
    jw, tw = _pair(_normal(shape, 0), scheme, dtype)
    want_dtype = torch.int8 if scheme == "int8" else torch.uint8
    assert tw.data.dtype == want_dtype and tw.scales.dtype == torch.float32
    np.testing.assert_array_equal(tw.data.numpy(), np.asarray(jw.data))
    np.testing.assert_array_equal(tw.scales.numpy(), np.asarray(jw.scales))
    assert (tw.shape, tw.scheme, tw.block_size) == (jw.shape, jw.scheme, jw.block_size)
    assert tw.nbytes == jw.nbytes and tw.dtype == want_dtype
    for dt_j, dt_t in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        got = tq.dequantize_weight(tw, dt_t).float().numpy()
        np.testing.assert_array_equal(got, np.asarray(jq.dequantize_weight(jw, dt_j), np.float32))


def test_quantize_all_zero_column_and_2d_only():
    w = _normal((16, 8), 1)
    w[:, 3] = 0.0
    jw, tw = _pair(w, "int8")
    np.testing.assert_array_equal(tw.scales.numpy(), np.asarray(jw.scales))
    assert float(tw.scales[3]) == np.float32(1e-8) / np.float32(127.0)
    assert not tw.data[:, 3].any()
    with pytest.raises(ValueError, match="2-D"):
        tq.quantize_weight(torch.zeros(4))
    with pytest.raises(ValueError, match="unknown scheme"):
        tq.quantize_weight(torch.zeros(4, 4), "fp4")


# ---------------------------------------------------------------------- int8 matmul
def _row_rel_err(got, want):
    """max |got - want| over each row's largest |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    g2, w2 = got.reshape(-1, got.shape[-1]), want.reshape(-1, want.shape[-1])
    scale = np.abs(w2).max(axis=1, keepdims=True) + 1e-30
    return float((np.abs(g2 - w2) / scale).max())


def _within_bf16_step(got, want):
    """Each element within one bf16 step (2^(e-7)) of |want| (want as fp32 values)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    step = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    return bool(np.all(np.abs(got - want) <= step))


INT8_CASES = {
    "8x64_at_64x32": ((8, 64), (64, 32)),
    "ragged_130x200_at_200x72": ((130, 200), (200, 72)),
    "3d_2x3x32_at_32x8": ((2, 3, 32), (32, 8)),
}


@pytest.mark.parametrize("case", list(INT8_CASES))
def test_int8_matmul_fp32_matches_jax_pallas(case):
    xs, ws = INT8_CASES[case]
    x = _normal(xs, 4)
    jw, tw = _pair(_normal(ws, 5, 0.1), "int8")
    want = jq.quant_matmul(jnp.asarray(x), jw)  # the Pallas kernel, interpret mode
    got = tq.quant_matmul(torch.from_numpy(x), tw)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert _row_rel_err(got.numpy(), want) <= 1e-5
    plain = tq.int8_matmul_reference(torch.from_numpy(x), tw.data, tw.scales, torch.float32)
    assert torch.equal(plain, got)


@pytest.mark.parametrize("case", list(INT8_CASES))
def test_int8_matmul_bf16_matches_jax_pallas(case):
    """bf16 x, bf16 out: (x_fp32 @ q) * s rounded once — within one bf16 step of JAX's;
    the dequantize-then-multiply path (bf16 weight) is further off."""
    xs, ws = INT8_CASES[case]
    x = _bf16_np(_normal(xs, 6))
    jw, tw = _pair(_normal(ws, 7, 0.1), "int8")
    want = jq.quant_matmul(jnp.asarray(x, jnp.bfloat16), jw, out_dtype=jnp.bfloat16)
    got = tq.quant_matmul(torch.from_numpy(x).to(torch.bfloat16), tw, out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    assert _within_bf16_step(got.float().numpy(), np.asarray(want, np.float32))
    out32 = tq.quant_matmul(torch.from_numpy(x).to(torch.bfloat16), tw, out_dtype=torch.float32)
    want32 = jq.quant_matmul(jnp.asarray(x, jnp.bfloat16), jw, out_dtype=jnp.float32)
    assert _row_rel_err(out32.numpy(), want32) <= 1e-5
    if case == "ragged_130x200_at_200x72":
        deq = tq.quant_matmul(torch.from_numpy(x).to(torch.bfloat16), tw,
                              out_dtype=torch.float32, use_kernel=False)
        assert _row_rel_err(deq.numpy(), want32) > 1e-4  # another function in bf16


def test_int8_matmul_dx_matches_jax_grad():
    x = _normal((8, 32), 10)
    jw, tw = _pair(_normal((32, 24), 11), "int8")
    jdx = jax.grad(lambda a: jnp.sum(jq.quant_matmul(a, jw) ** 2))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    scales = tw.scales.clone().requires_grad_()
    qw = dataclasses.replace(tw, scales=scales)
    (tq.quant_matmul(xt, qw) ** 2).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jdx), rtol=1e-5, atol=1e-5)
    assert torch.equal(scales.grad, torch.zeros_like(scales))
    # 3-D x in bf16: the gradient comes back in x's dtype.
    x3 = torch.from_numpy(_normal((2, 3, 32), 12)).to(torch.bfloat16).requires_grad_()
    tq.quant_matmul(x3, tw, out_dtype=torch.float32).sum().backward()
    assert x3.grad.dtype == torch.bfloat16 and x3.grad.shape == x3.shape


def test_int8_matmul_shape_errors():
    tw = tq.quantize_weight(torch.ones(8, 4))
    with pytest.raises(ValueError, match="x \\[..., K\\]"):
        tq.int8_matmul(torch.ones(2, 7), tw.data, tw.scales, torch.float32)


@pytest.mark.parametrize("scheme", ["int4", "nf4"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_4bit_quant_matmul_matches_jax(scheme, dtype):
    x = _bf16_np(_normal((8, 64), 1)) if dtype == "bfloat16" else _normal((8, 64), 1)
    jw, tw = _pair(_normal((64, 40), 2, 0.1), scheme)
    jd, td = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else (jnp.float32,
                                                                          torch.float32)
    want = np.asarray(jq.quant_matmul(jnp.asarray(x, jd), jw).astype(jnp.float32))
    got = tq.quant_matmul(torch.from_numpy(x).to(td), tw)
    assert got.dtype == td
    if dtype == "float32":
        assert _row_rel_err(got.numpy(), want) <= 1e-5
    else:
        assert _within_bf16_step(got.float().numpy(), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_use_kernel_false_matches_jax_use_pallas_false(dtype):
    x = _normal((16, 48), 3)
    jd, td = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else (jnp.float32,
                                                                          torch.float32)
    x = _bf16_np(x) if dtype == "bfloat16" else x
    jw, tw = _pair(_normal((48, 24), 4, 0.1), "int8")
    want = np.asarray(jq.quant_matmul(jnp.asarray(x, jd), jw, use_pallas=False)
                      .astype(jnp.float32))
    got = tq.quant_matmul(torch.from_numpy(x).to(td), tw, use_kernel=False).float().numpy()
    if dtype == "float32":
        assert _row_rel_err(got, want) <= 1e-5
    else:
        assert _within_bf16_step(got, want)
    # 1-D x takes the dequantize path in both packages.
    x1 = _normal((48,), 5)
    np.testing.assert_allclose(
        tq.quant_matmul(torch.from_numpy(x1), tw).numpy(),
        np.asarray(jq.quant_matmul(jnp.asarray(x1), jw)), rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------------- model transform
def test_config_validation():
    with pytest.raises(ValueError):
        tq.BnbQuantizationConfig(load_in_8bit=True, load_in_4bit=True)
    with pytest.raises(ValueError):
        tq.BnbQuantizationConfig()
    with pytest.raises(ValueError):
        tq.BnbQuantizationConfig(load_in_4bit=True, bnb_4bit_quant_type="fp4x")
    assert tq.BnbQuantizationConfig(load_in_8bit=True).scheme == "int8"
    assert tq.BnbQuantizationConfig(load_in_4bit=True, bnb_4bit_quant_type="nf4").scheme == "nf4"
    assert tq.BnbQuantizationConfig(load_in_4bit=True).scheme == "int4"


def _at(tree, key):
    """The leaf of ``tree`` at key path ``key`` ("layers/0/wq")."""
    for part in key.split("/"):
        tree = tree[int(part)] if isinstance(tree, list) else tree[part]
    return tree


def _quantized_leaves(tree, path=""):
    """{key path: QuantizedWeight} of a JAX or port params tree."""
    if isinstance(tree, (jq.QuantizedWeight, tq.QuantizedWeight)):
        return {path: tree}
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {}
    out = {}
    for k, v in items:
        out.update(_quantized_leaves(v, f"{path}/{k}" if path else str(k)))
    return out


QCONFIGS = {
    "int8_skip_embed_head_min1": dict(load_in_8bit=True, skip_modules=["embed", "lm_head"],
                                      min_weight_size=1),
    "nf4_default_min": dict(load_in_4bit=True, bnb_4bit_quant_type="nf4"),
    "int4_keep_wo_min10000": dict(load_in_4bit=True, keep_in_fp32_modules=["wo"],
                                  min_weight_size=10000, block_size=32),
}


@pytest.fixture(scope="module")
def tiny_params():
    jcfg = dataclasses.replace(jl.CONFIGS["tiny"], dtype=jnp.float32)
    tcfg = dataclasses.replace(tl.CONFIGS["tiny"], dtype=torch.float32)
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(2))
    return jcfg, tcfg, jparams, params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                                                device="cpu")


@pytest.mark.parametrize("name", list(QCONFIGS))
def test_load_and_quantize_model_matches_jax(tiny_params, name):
    _, _, jparams, tparams = tiny_params
    kw = QCONFIGS[name]
    jq_params = jq.load_and_quantize_model(jparams, jq.BnbQuantizationConfig(**kw))
    tq_params = tq.load_and_quantize_model(tparams, tq.BnbQuantizationConfig(**kw))
    jleaves, tleaves = _quantized_leaves(jq_params), _quantized_leaves(tq_params)
    assert sorted(tleaves) == sorted(jleaves) and tleaves
    for key, tw in tleaves.items():
        jw = jleaves[key]
        np.testing.assert_array_equal(tw.data.numpy(), np.asarray(jw.data))
        np.testing.assert_array_equal(tw.scales.numpy(), np.asarray(jw.scales))
        assert (tw.shape, tw.scheme, tw.block_size) == (jw.shape, jw.scheme, jw.block_size)
    assert isinstance(tq_params["layers"], list) and len(tq_params["layers"]) == 2
    assert torch.equal(tq_params["ln_f"], tparams["ln_f"])
    # dequantize_model inverts the leaf transform as JAX's does.
    jd = jq.dequantize_model(jq_params)
    td = tq.dequantize_model(tq_params)
    for key in jleaves:
        np.testing.assert_array_equal(_at(td, key).numpy(), np.asarray(_at(jd, key)))


@pytest.mark.parametrize("scheme", ["int8", "nf4"])
def test_params_from_jax_and_back_keep_quantized_leaves(tiny_params, scheme):
    jcfg, tcfg, jparams, _ = tiny_params
    kw = (dict(load_in_8bit=True) if scheme == "int8"
          else dict(load_in_4bit=True, bnb_4bit_quant_type="nf4"))
    jqp = jq.load_and_quantize_model(jparams, jq.BnbQuantizationConfig(
        skip_modules=["embed", "lm_head"], min_weight_size=1, **kw))
    np_params = jax.tree.map(np.asarray, jqp)
    for dtype in (torch.float32, torch.bfloat16):
        cfg = dataclasses.replace(tcfg, dtype=dtype)
        tp = params_from_jax(np_params, cfg, device="cpu")
        assert tp["embed"].dtype == dtype
        assert sorted(_quantized_leaves(tp)) == sorted(_quantized_leaves(np_params))
        for key, tw in _quantized_leaves(tp).items():
            jw = _at(np_params, key)
            assert isinstance(tw, tq.QuantizedWeight)
            assert tw.data.dtype == (torch.int8 if scheme == "int8" else torch.uint8)
            assert tw.scales.dtype == torch.float32
            np.testing.assert_array_equal(tw.data.numpy(), jw.data)
            np.testing.assert_array_equal(tw.scales.numpy(), jw.scales)
        back = params_to_numpy(tp)
        for key, bw in _quantized_leaves(back).items():
            jw = _at(np_params, key)
            assert isinstance(bw.data, np.ndarray) and bw.data.dtype == jw.data.dtype
            np.testing.assert_array_equal(bw.data, jw.data)
            np.testing.assert_array_equal(bw.scales, jw.scales)
        again = params_from_jax(back, cfg, device="cpu")
        for key, tw in _quantized_leaves(tp).items():
            aw = _quantized_leaves(again)[key]
            assert torch.equal(aw.data, tw.data) and torch.equal(aw.scales, tw.scales)
        with pytest.raises(NotImplementedError, match="stacked"):
            params_to_numpy(tp, stacked=True)


# ----------------------------------------------------------------- the kernel's plan
MAIN_SHAPES = [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096)]  # (K, N)


def _grid(plan, M, N):
    """Blocks of the launch: token tiles × 128-column tiles × K ranges."""
    return -(-M // plan.bm) * -(-N // 128) * plan.splits


def _covers_k(plan, K):
    """Every K range non-empty, whole 64-row tiles, together all of K."""
    return (plan.k_chunk % 64 == 0
            and plan.splits * plan.k_chunk >= K > (plan.splits - 1) * plan.k_chunk)


@pytest.mark.parametrize("M", [8, 64])
@pytest.mark.parametrize("K,N", MAIN_SHAPES)
def test_split_plan_fills_the_card(M, K, N):
    """At the serving path's shapes the plan takes the cluster kernel and its grid holds
    at least one block per SM (at least 128 blocks on an H100's 132), in one wave of about
    two blocks an SM at the most; the K ranges cover K in whole tiles; clusters of at most
    7 blocks, except where 7 leave SMs idle (N = 1024: 8 column tiles), which take 32
    tokens a block at M = 64 and clusters of up to 16 (the non-portable size)."""
    plan = tq.split_plan(M, N, K, 132)
    assert plan.route == "cluster" and plan.bm == (8 if M <= 8 else 32 if N == 1024 else 64)
    assert tq._MOST_SPLITS == 7 and tq.MAX_CLUSTER == 16
    tiles = -(-N // 128)
    assert 1 <= plan.splits <= (7 if tiles * 7 >= 132 else 16)
    assert _covers_k(plan, K)
    assert 128 <= _grid(plan, M, N) <= 2 * 132


@pytest.mark.parametrize("M,bm", [(1, 8), (6, 8), (16, 16), (32, 32), (64, 32), (65, 32),
                                  (128, 32)])
def test_split_plan_cluster_token_tiles(M, bm):
    """Tokens per block: the smallest wgmma n that holds M (at most 64, then more token
    tiles), halved down to 32 where one block per SM would take clusters past 8 (this
    weight has 8 column tiles); the K split then shrinks as the grid grows, and the grid
    keeps at least 128 blocks (one an SM) and at most two an SM."""
    plan = tq.split_plan(M, 1024, 4096, 132)
    assert plan.route == "cluster" and plan.bm == bm and _covers_k(plan, 4096)
    tiles = -(-M // bm) * 8
    want = min(16, -(-132 // tiles))  # K ranges of whole tiles may merge
    assert plan.splits <= want and _grid(plan, M, 1024) == tiles * plan.splits
    assert 128 <= _grid(plan, M, 1024) <= 2 * 132


@pytest.mark.parametrize("M,N,K,bf16,tma,route", [
    (130, 72, 200, True, True, "ragged"),     # N % 16 != 0
    (1, 5, 3, True, True, "ragged"),
    (8, 1024, 4100, True, True, "ragged"),    # K % 8 != 0
    (8, 1024, 4096, True, False, "ragged"),   # a tensor off a 16-byte boundary
    (8, 32, 0, True, True, "ragged"),         # K = 0
    (300, 1000, 256, False, True, "fp32"),
    (6, 24, 10, False, True, "fp32"),
])
def test_split_plan_small_and_fp32_shapes(M, N, K, bf16, tma, route):
    """Shapes outside the cluster kernel's TMA rules take the bounds-checked bf16 kernel
    (one block per 128 columns and 16/32/64 rows, K unsplit); fp32 x the CUDA-core kernel
    with its split-K partials."""
    plan = tq.split_plan(M, N, K, 132, bf16=bf16, tma=tma)
    assert plan.route == route
    if route == "ragged":
        assert plan.bm in (16, 32, 64) and plan.splits == 1 and plan.k_chunk >= max(K, 1)
        assert plan.k_chunk % 64 == 0
    else:
        assert plan.bm == 32 and plan.k_chunk % 32 == 0
        assert plan.splits * plan.k_chunk >= K > (plan.splits - 1) * plan.k_chunk


def test_split_plan_is_pure_and_cached():
    """The plan is a function of (M, N, K, SMs, dtype, TMA rules) alone."""
    a = tq.split_plan(8, 4096, 4096, 132)
    assert tq.split_plan(8, 4096, 4096, 132) is a
    assert tq.split_plan(8, 4096, 4096, 66).splits >= a.splits // 2
