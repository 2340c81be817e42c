"""Paged attention of the PyTorch port against the JAX package, on the CPU.

The same numpy inputs (seeded) build a paged pool on both sides through each side's
``write_kv_paged``; the port's ``paged_attention`` (on CPU tensors: its plain version)
is then held against the JAX Pallas kernel in interpret mode and against the JAX
plain reference. Inputs cover GQA groups of 1 and 4, T of 1 and 3, fp32 and bf16,
int8 pools, a sliding window, a softcap, a sentinel entry inside a lane's range and a
never-written lane. The CUDA kernel itself runs only on the card (``chip_smoke.py``);
here its bf16 schedule is tested as the pure functions it mirrors (``cluster_blocks``,
``lane_tiles``), and chip_smoke's chunked reference of that schedule is held against
the JAX kernel at the schedule's edges.

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


# ------------------------------------------------- the bf16 kernel's cluster schedule
# The CUDA kernel splits each (lane, kv head) over the blocks of a thread block cluster
# (``cluster_blocks``), each block walking a contiguous share of the lane's 64-slot tiles
# (``lane_tiles``) before the blocks merge in rank order. The plan and the shares are
# pure functions the kernel mirrors; chip_smoke's ``paged_chunked_reference`` computes
# that split with the plain math and is held here against the JAX Pallas kernel.
SERVING = dict(B=8, K=8, MP=64, page_size=16)  # 8 lanes, Llama-3-8B's kv heads, max_len 1024


@pytest.mark.parametrize("B,K,MP,ps,blocks", [
    (8, 8, 64, 16, 4),      # the serving path: 64 clusters of 4 on 132 SMs, one wave
    (8, 8, 256, 16, 4),     # max_len 4096: 64 tiles a full lane, still 4 blocks
    (1, 8, 64, 16, 8),      # one lane: a block per tile up to 8
    (2, 1, 2, 16, 1),       # a lane of 32 slots fits one tile
    (8, 8, 40, 8, 4),       # page size 8
    (64, 8, 64, 16, 1),     # 512 clusters: one block each
])
def test_cluster_blocks(B, K, MP, ps, blocks):
    """At most 8 blocks (the portable cluster), at most one per tile of a full lane, and
    no more than keep the B·K clusters at two blocks an SM (one wave on 132 SMs)."""
    got = tpa.cluster_blocks(B, K, MP, ps, 132)
    assert got == blocks and tpa.TILE_SLOTS == 64
    assert 1 <= got <= tpa.MAX_CLUSTER == 8
    assert got * B * K <= max(2 * 132, B * K)
    assert got <= max(1, -(-(MP * ps) // 64))


@pytest.mark.parametrize("bf16,T,H,hd,ps,aligned,route", [
    (True, 1, 32, 128, 16, True, "cluster"),   # the serving path
    (True, 16, 32, 128, 16, True, "cluster"),  # 64 query rows, the most
    (True, 8, 16, 256, 8, True, "cluster"),    # 16 rows at head dim 256
    (True, 1, 32, 128, 24, True, "pair"),      # page size 24 (the JAX program lowering's)
    (True, 2, 32, 128, 4, True, "pair"),       # page size 4 (the JAX engines' tests')
    (True, 17, 32, 128, 16, True, "pair"),     # 68 query rows
    (True, 17, 16, 256, 16, True, "pair"),     # 34 rows at head dim 256
    (True, 1, 32, 128, 16, False, "pair"),     # q off a 16-byte boundary
    (False, 1, 32, 128, 16, True, "pair"),     # fp32 q
])
def test_paged_plan_routes_by_shape(bf16, T, H, hd, ps, aligned, route):
    """bf16 q takes the cluster kernel on every shape it takes (page sizes a power of two
    of at least 8, at most 64 query rows T·H/K, 32 at head dim 256, aligned tensors) and
    the partial + combine pair on the others; fp32 q always the pair."""
    plan = tpa.paged_plan(bf16, 8, T, H, 8, hd, ps, 64, 132, aligned)
    assert plan.route == route
    assert plan.blocks == (tpa.cluster_blocks(8, 8, 64, ps, 132) if route == "cluster" else 0)


def _live_tiles(pos0, T, MP, ps, window):
    end = min(pos0 + T, MP * ps)
    first = max(0, pos0 - window + 1) if window else 0
    return [t for t in range(-(-(MP * ps) // 64)) if t * 64 < end and (t + 1) * 64 > first]


@pytest.mark.parametrize("max_len", [1024, 4096])
@pytest.mark.parametrize("blocks", [1, 4, 8])
def test_lane_tiles_partition_the_live_range(max_len, blocks):
    """The blocks' shares of a lane at max_len 1024 and 4096: contiguous, in rank order,
    together exactly the tiles holding a live slot, none larger than ceil(n / blocks),
    and the empty shares (blocks with nothing to do) only after the last full one."""
    MP, ps = max_len // 16, 16
    rng = np.random.default_rng(max_len + blocks)
    cases = [(0, 1, 0), (63, 1, 0), (64, 1, 0), (127, 1, 0), (max_len - 1, 1, 0),
             (max_len - 4, 4, 0), (511, 4, 100), (3000 % max_len, 3, 64)]
    cases += [(int(p), 1, 0) for p in rng.integers(0, max_len, 6)]
    for pos0, T, window in cases:
        shares = tpa.lane_tiles(pos0, T, MP, ps, window, blocks)
        assert len(shares) == blocks
        flat = [t for s in shares for t in s]
        assert flat == _live_tiles(pos0, T, MP, ps, window)
        n = len(flat)
        assert all(len(s) <= -(-n // blocks) for s in shares)
        sizes = [len(s) for s in shares]
        assert sizes == sorted(sizes, reverse=True) and sizes[0] == -(-n // blocks)


def test_lane_tiles_edges():
    """A lane of one live slot is one tile for the first block; a lane ending on a tile
    boundary has no tile past it; a lane of 4096 slots over 8 blocks gives each 8."""
    assert [list(s) for s in tpa.lane_tiles(0, 1, 64, 16, 0, 4)] == [[0], [], [], []]
    assert [list(s) for s in tpa.lane_tiles(127, 1, 64, 16, 0, 4)] == [[0], [1], [], []]
    shares = tpa.lane_tiles(4095, 1, 256, 16, 0, 8)
    assert [len(s) for s in shares] == [8] * 8 and shares[-1][-1] == 63


def _lanes_case(seed, *, lens, alloc=None, T=1, H=4, K=2, hd=16, ps=16, MP=8,
                dtype="float32", quantized=False):
    """Seeded inputs on both sides with every lane's length set: lane b's slots end at
    lens[b] (its first query at lens[b] - T); its first alloc[b] slots are written and
    valid and the pages past them keep sentinel entries (all-sentinel tail pages)."""
    rng = np.random.default_rng(seed)
    B = len(lens)
    C = MP * ps
    P = B * MP
    alloc = alloc or lens
    tables = np.full((B, MP), P, np.int32)
    valid = np.zeros((B, C), bool)
    perm = rng.permutation(P)
    for b, n in enumerate(alloc):
        n = min(n, lens[b])
        n_pages = -(-n // ps)
        tables[b, :n_pages] = perm[b * MP:b * MP + n_pages]
        valid[b, :n] = True
    kv = rng.standard_normal((2, B, C, K, hd)).astype(np.float32)
    pos = np.arange(C)
    pages = np.where(valid, tables[:, np.minimum(pos // ps, MP - 1)], P).astype(np.int32)
    offs = np.broadcast_to(pos % ps, (B, C)).astype(np.int32)
    q = rng.standard_normal((B, T, H, hd)).astype(np.float32)
    positions = np.maximum(np.asarray(lens) - T, 0).astype(np.int32)
    jpool = jcommon.paged_kv_planes(P, ps, K, hd, JNP[dtype], quantized)
    tpool = tcommon.paged_kv_planes(P, ps, K, hd, TORCH[dtype], quantized)
    for i, name in enumerate("kv"):
        jpool.update(jcommon.write_kv_paged(
            jpool, name, jnp.asarray(kv[i]).astype(JNP[dtype]), jnp.asarray(pages),
            jnp.asarray(offs)))
        tcommon.write_kv_paged(tpool, name, torch.from_numpy(kv[i]).to(TORCH[dtype]),
                               torch.from_numpy(pages), torch.from_numpy(offs))
    jargs = (jnp.asarray(q).astype(JNP[dtype]), jpool, jnp.asarray(tables),
             jnp.asarray(positions), jnp.asarray(valid))
    targs = (torch.from_numpy(q).to(TORCH[dtype]), tpool, torch.from_numpy(tables),
             torch.from_numpy(positions), torch.from_numpy(valid))
    return jargs, targs, dict(page_size=ps, sm_scale=hd ** -0.5)


CHUNKED_CASES = {
    # (lens, alloc, shape overrides, kwargs)
    "lane_past_its_cluster": ([1000, 37, 640, 999], None, dict(MP=64), {}),
    "one_live_slot": ([1, 1, 2, 1], None, {}, {}),
    "ends_on_tile_boundary": ([64, 128, 63, 65], None, {}, {}),
    "sentinel_tail_pages": ([128, 100, 128, 77], [20, 100, 1, 64], {}, {}),
    "bf16_lane_past_its_cluster": ([1000, 5, 640, 511], None, dict(MP=64, dtype="bfloat16"),
                                   {}),
    "int8_bf16_window_T2": ([120, 90, 128, 65], None, dict(T=2, dtype="bfloat16",
                                                          quantized=True), {"window": 40}),
    "softcap_G4_T3": ([128, 9, 70, 100], None, dict(T=3, H=8), {"softcap": 20.0}),
}


@pytest.mark.parametrize("case", list(CHUNKED_CASES))
def test_chunked_reference_matches_jax(case):
    """chip_smoke's chunked reference — per-tile (m, l, acc) over each block's share,
    merged in rank order — against the JAX Pallas kernel (interpret mode) at the cluster
    schedule's edges: a lane with more tiles than its cluster has blocks, lanes of one
    live slot, lanes ending on a tile boundary, all-sentinel tail pages. Tolerances as
    above: 1e-5 fp32 (the order of the fp32 sums), 2e-2 bf16 (p rounded to bf16 after a
    per-tile rather than a per-page max)."""
    import chip_smoke

    lens, alloc, shape, kw = CHUNKED_CASES[case]
    jargs, targs, base = _lanes_case(7, lens=lens, alloc=alloc, **shape)
    kw = dict(base, **kw)
    dtype = shape.get("dtype", "float32")
    got = chip_smoke.paged_chunked_reference(*targs, **kw)
    want = jpa.paged_attention(*jargs, **kw, interpret=True)
    assert got.dtype == TORCH[dtype] and tuple(got.shape) == tuple(jargs[0].shape)
    np.testing.assert_allclose(_np(got), _np(want), atol=ATOL[dtype], rtol=0)
    # And the port's plain version agrees with both.
    plain = tpa.paged_attention(*targs, **kw)
    np.testing.assert_allclose(_np(plain), _np(want), atol=ATOL[dtype], rtol=0)


@pytest.mark.parametrize("ps,MP,lens,quantized", [
    (24, 32, [700, 24, 257, 512], False),
    (4, 160, [640, 3, 256, 300], True),
])
def test_chunked_reference_on_the_pair_split_matches_jax(ps, MP, lens, quantized):
    """bf16 calls at page sizes outside the cluster kernel's rules (24, 4) take the
    partial + combine pair, whose chunks (256 slots at head dim 16) each round p after
    their own max: chip_smoke's reference on that split (one chunk a block) against the
    JAX Pallas kernel (interpret mode), to 2e-2 as above."""
    import chip_smoke

    jargs, targs, kw = _lanes_case(11, lens=lens, MP=MP, ps=ps, dtype="bfloat16",
                                   quantized=quantized)
    assert tpa.paged_plan(True, 4, 1, 4, 2, 16, ps, MP, 132).route == "pair"
    got = chip_smoke.paged_chunked_reference(*targs, **kw, split=(256, -(-(MP * ps) // 256)))
    want = jpa.paged_attention(*jargs, **kw, interpret=True)
    np.testing.assert_allclose(_np(got), _np(want), atol=ATOL["bfloat16"], rtol=0)
