"""Fused AdamW: the Hopper CUDA kernel, its plain PyTorch version, and the optimizer.

Counterpart of ``accelerate_tpu/ops/fused_optim.py``. :class:`FusedAdamW` has the
transformation surface (``init``/``update``, plain math on every leaf) and
``fused_apply(grads, state, params, grad_scale)``, the single-pass apply that
``Accelerator.build_train_step`` uses when present: it folds the global-norm clip
factor into the pass and updates params and moments IN PLACE (the port's counterpart
of the JAX step's donated buffers), returning ``(params, state)``.

- :func:`adamw_leaf_reference` — the plain version of one leaf's update (the JAX
  ``_leaf_xla``), in ``optax.adamw``'s expression order.
- :func:`adamw_leaves` — the kernel wrapper over parallel lists of leaves. CPU
  tensors run the plain version leaf by leaf; CUDA tensors go to one launch of
  ``csrc/fused_adamw.cu`` per first-moment type (multi-tensor: every leaf in one
  launch), counted in ``adamw_leaves.launches``. A CUDA call never falls back: a
  refused device, type, layout or launch raises.
- Leaves whose size is a multiple of 1024 take :func:`adamw_leaves` (the JAX kernel's
  layout rule); the others take the plain version on any device.

``mu_dtype`` may be fp32 (default: the param's type), bf16, or an fp8 type; ``nu_dtype``
fp32 or an fp8 type (a bf16 second moment is not ported and raises). fp8 moments are
stored scaled, with one fp32 scale per leaf beside each (:class:`ScaledAdamState`, the
JAX package's MS-AMP analog, set up by ``FP8RecipeKwargs(opt_level="O2")``): CURRENT
scaling, ``scale = amax / fp8_max`` of the freshly computed moment (not
``ops.fp8.compute_scale``'s power of two). A leaf with an fp8 moment takes
:func:`adamw_leaf_scaled_reference`, plain PyTorch on any device, as JAX sends such
leaves through XLA rather than its Pallas kernel; every other leaf keeps the kernel.

``FusedAdamW.fused_apply_offloaded`` is the ``cpu_offload`` apply: the moments live in
host memory (pinned on CUDA) and stream through ``OFFLOAD_BUFFERS`` device staging
buffers of ``OFFLOAD_CHUNK_ELEMS`` elements in fixed-size chunks (the host-to-device
copy of chunk i+1 and the device-to-host copy of chunk i-1 run on two copy streams while
the kernel updates chunk i), one kernel launch a chunk. AdamW is elementwise, so the
chunks give the bits of the whole-tree apply. Leaves the kernel does not take (fp8
moments, sizes off the 1024 rule) fetch their moments whole, update and store them
back. On the CPU the host is the device: the same chunks, copied without streams.
:data:`OFFLOAD_STATS` holds the last call's chunks, bytes and copy seconds.
"""

from __future__ import annotations

import ctypes
import dataclasses
import time
from typing import Any, Callable, NamedTuple, Optional, Union

import torch

from ..optim import AdamState, bias_correction, scale_by
from ..utils.tree import tree_leaves, tree_map, tree_unflatten
from . import _build
from .fp8 import FP8_MAX, _amax

__all__ = ["FusedAdamW", "fused_adamw", "ScaledAdamState", "adamw_leaf_reference",
           "adamw_leaf_scaled_reference", "adamw_leaves", "OFFLOAD_CHUNK_ELEMS",
           "OFFLOAD_BUFFERS", "OFFLOAD_STATS", "offload_chunks"]

_LANES = 1024  # leaves whose size is a multiple of this take the kernel
#: Elements of one offload staging chunk (a multiple of 1024: 256 MiB of fp32 moment).
OFFLOAD_CHUNK_ELEMS = 64 << 20
#: Device staging buffers of the offload stream (each one chunk of both moments).
OFFLOAD_BUFFERS = 3
#: The last ``fused_apply_offloaded`` call's chunks, bytes and copy seconds.
OFFLOAD_STATS: dict = {}
_M_CODE = {torch.float32: 0, torch.bfloat16: 1}


class ScaledAdamState(NamedTuple):
    """AdamW state whose moments may be stored in fp8: ``mu_scale``/``nu_scale`` mirror
    the param tree with one fp32 0-d tensor per leaf, or are None for a moment kept in
    fp32/bf16. The leading fields are :class:`optim.AdamState`'s."""

    count: int
    mu: Any
    nu: Any
    mu_scale: Any = None
    nu_scale: Any = None


def _is_f8(dtype) -> bool:
    return dtype in FP8_MAX


def _quant_f8(x32: torch.Tensor, dtype, group=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor current scaling: ``scale = max(amax, 1e-30) / fp8_max``, codes
    ``x / scale`` (divisions by tensors, as XLA divides). ``group``: the ranks holding
    the other shards of the tensor (the amax is theirs too, as GSPMD's is global)."""
    amax = _amax(x32, group)
    scale = torch.clamp_min(amax, 1e-30) / torch.full_like(amax, FP8_MAX[dtype])
    return (x32 / scale).to(dtype), scale


def _dequant_f8(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return x.float() * scale


def adamw_leaf_reference(p, m, v, g, scalars, *, b1, b2, eps, wd):
    """Plain update of one leaf → ``(p', m', v')``. ``scalars`` = fp32 ``[grad_scale,
    lr, 1 - b1^t, 1 - b2^t]``."""
    gscale, lr, bc1, bc2 = scalars[0], scalars[1], scalars[2], scalars[3]
    g = g.float() * gscale
    p32 = p.float()
    m_new = scale_by(1.0 - b1, g) + scale_by(b1, m)  # promotion order = optax update_moment
    v_new = scale_by(1.0 - b2, g * g) + scale_by(b2, v)
    update = (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps) + scale_by(wd, p32)
    p_new = (p32 - lr * update).to(p.dtype)
    return p_new, m_new.to(m.dtype), v_new.to(v.dtype)


def adamw_leaf_scaled_reference(p, m, v, g, scalars, m_scale, v_scale, *, b1, b2, eps, wd,
                                group=None):
    """Update of a leaf with fp8 moments (the JAX ``_leaf_xla_scaled``): dequantize
    with last step's scale, :func:`adamw_leaf_reference` on the fp32 moments, requantize
    with the fresh amax (over ``group`` for a tp shard) → ``(p', m', v', m_scale',
    v_scale')``; a scale is None for a moment that is not fp8 (with both None,
    :func:`adamw_leaf_reference`'s values)."""
    m_in = _dequant_f8(m, m_scale) if m_scale is not None else m
    v_in = _dequant_f8(v, v_scale) if v_scale is not None else v
    p_new, m_new, v_new = adamw_leaf_reference(p, m_in, v_in, g, scalars,
                                               b1=b1, b2=b2, eps=eps, wd=wd)
    m_out, m_scale_out = (_quant_f8(m_new, m.dtype, group) if m_scale is not None
                          else (m_new, None))
    v_out, v_scale_out = (_quant_f8(v_new, v.dtype, group) if v_scale is not None
                          else (v_new, None))
    return p_new, m_out, v_out, m_scale_out, v_scale_out


# ------------------------------------------------------------------------ CUDA launches
def _lib() -> ctypes.CDLL:
    lib = _build.load("fused_adamw")
    if not getattr(lib, "_argtypes_set", False):
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.fused_adamw_launch.argtypes = [vp, ci, ctypes.c_int64, vp] + [cf] * 6 + [ci, vp]
        lib.fused_adamw_launch.restype = ci
        lib.fused_adamw_block_elems.argtypes = []
        lib.fused_adamw_block_elems.restype = ci
        lib._argtypes_set = True
    return lib


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"fused_adamw kernel: {msg}")


def _adamw_cuda(params, mus, nus, grads, scalars, *, b1, b2, eps, wd):
    dev = params[0].device
    _check(dev.type == "cuda", f"tensors must be on CUDA, got {dev}")
    _check(scalars.device == dev and scalars.dtype == torch.float32 and scalars.numel() == 4,
           "scalars must be fp32 [4] on the params' device")
    groups = {}
    for p, m, v, g in zip(params, mus, nus, grads):
        for name, t in (("p", p), ("m", m), ("v", v), ("g", g)):
            _check(t.device == dev, f"{name} on {t.device}, params on {dev}")
            _check(t.is_contiguous() and t.data_ptr() % 16 == 0,
                   f"{name} must be contiguous and 16-byte aligned")
            _check(t.numel() == p.numel(), f"{name} has {t.numel()} elements, p {p.numel()}")
        _check(p.dtype == v.dtype == g.dtype == torch.float32, "p, v and g must be fp32")
        _check(m.dtype in _M_CODE, f"first moment dtype {m.dtype} (fp32 or bf16)")
        _check(p.numel() % _LANES == 0, f"leaf size {p.numel()} is not a multiple of {_LANES}")
        groups.setdefault(m.dtype, []).append((p, m, v, g))
    lib = _lib()
    per_block = lib.fused_adamw_block_elems()
    stream = torch.cuda.current_stream(dev).cuda_stream
    for m_dtype, leaves in groups.items():
        rows, first = [], 0
        for p, m, v, g in leaves:
            rows += [p.data_ptr(), m.data_ptr(), v.data_ptr(), g.data_ptr(), p.numel(), first]
            first += -(-p.numel() // per_block)
        table = torch.tensor(rows, dtype=torch.int64).to(dev)
        b1_m = float(torch.tensor(b1, dtype=m_dtype))
        with torch.cuda.device(dev):
            err = lib.fused_adamw_launch(
                table.data_ptr(), len(leaves), first, scalars.data_ptr(), b1_m, 1.0 - b1, b2,
                1.0 - b2, eps, wd, _M_CODE[m_dtype], stream)
        if err != 0:
            raise RuntimeError(f"fused_adamw kernel launch failed: CUDA error {err}")
        adamw_leaves.launches += 1


@torch.no_grad()
def _apply_plain(leaves, scalars, kw) -> None:
    for p, m, v, g in leaves:
        p_new, m_new, v_new = adamw_leaf_reference(p, m, v, g, scalars, **kw)
        p.copy_(p_new)
        m.copy_(m_new)
        v.copy_(v_new)


@torch.no_grad()
def _apply_scaled(leaves, scalars, kw) -> None:
    for p, m, v, g, ms, vs, group in leaves:
        out = adamw_leaf_scaled_reference(p, m, v, g, scalars, ms, vs, **kw, group=group)
        for dst, src in zip((p, m, v, ms, vs), out):
            if dst is not None:
                dst.copy_(src)


def adamw_leaves(params, mus, nus, grads, scalars, *, b1, b2, eps, wd) -> None:
    """One-pass AdamW over parallel lists of leaves, IN PLACE on ``params``, ``mus``
    and ``nus``. CPU tensors run :func:`adamw_leaf_reference`; others launch the
    kernel (leaf sizes must be multiples of 1024)."""
    if not params:
        return
    if params[0].device.type == "cpu":
        _apply_plain(zip(params, mus, nus, grads), scalars, dict(b1=b1, b2=b2, eps=eps, wd=wd))
        return
    _adamw_cuda(params, mus, nus, grads, scalars, b1=b1, b2=b2, eps=eps, wd=wd)


#: Kernel launches since the count was last reset (CPU calls are not counted).
adamw_leaves.launches = 0


# ---------------------------------------------------------------------------- optimizer
@dataclasses.dataclass
class FusedAdamW:
    """AdamW with a fused single-pass apply (the JAX ``FusedAdamW``).

    ``learning_rate`` is a float or a schedule called on the step count.
    ``use_kernel=False`` keeps ``fused_apply``'s framing but runs the plain math on
    every leaf."""

    learning_rate: Union[float, Callable[[int], Any]] = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 1e-4
    mu_dtype: Optional[torch.dtype] = None
    nu_dtype: Optional[torch.dtype] = None
    use_kernel: Optional[bool] = None

    def __post_init__(self):
        if self.mu_dtype not in (None, torch.float32, torch.bfloat16, *FP8_MAX):
            raise NotImplementedError(
                f"mu_dtype={self.mu_dtype}: fp32, bf16 and fp8 first moments are ported")
        if self.nu_dtype not in (None, torch.float32, *FP8_MAX):
            raise NotImplementedError(
                f"nu_dtype={self.nu_dtype}: the second moment is kept in fp32 or scaled fp8 "
                "(a bf16 second moment is not ported)")

    def init(self, params):
        """``optim.AdamState``, or :class:`ScaledAdamState` when a moment is fp8 (its
        scales start at 1)."""
        mu = tree_map(lambda p: torch.zeros_like(p, dtype=self.mu_dtype or p.dtype), params)
        nu = tree_map(lambda p: torch.zeros_like(p, dtype=self.nu_dtype or p.dtype), params)
        if not (_is_f8(self.mu_dtype) or _is_f8(self.nu_dtype)):
            return AdamState(count=0, mu=mu, nu=nu)

        def ones():
            return tree_map(lambda p: torch.ones((), dtype=torch.float32, device=p.device),
                            params)

        return ScaledAdamState(count=0, mu=mu, nu=nu,
                               mu_scale=ones() if _is_f8(self.mu_dtype) else None,
                               nu_scale=ones() if _is_f8(self.nu_dtype) else None)

    @staticmethod
    def _flat_scales(state, n: int) -> tuple[list, list]:
        """Per-leaf (mu_scale, nu_scale) lists: all None for a plain ``AdamState``."""
        ms, vs = getattr(state, "mu_scale", None), getattr(state, "nu_scale", None)
        return (tree_leaves(ms) if ms is not None else [None] * n,
                tree_leaves(vs) if vs is not None else [None] * n)

    @staticmethod
    def _next_state(state, **fields):
        """The state after a step, of the incoming state's type."""
        return state._replace(count=state.count + 1, **fields)

    def _scalars(self, count: int, grad_scale, device) -> torch.Tensor:
        """fp32 ``[grad_scale, lr, 1 - b1^t, 1 - b2^t]`` on ``device``; ``grad_scale``
        may be a tensor already on the device (no host sync)."""
        lr = self.learning_rate(count) if callable(self.learning_rate) else self.learning_rate
        t = count + 1
        rest = torch.tensor([float(lr), bias_correction(self.b1, t), bias_correction(self.b2, t)],
                            dtype=torch.float32)
        gs = torch.as_tensor(grad_scale, dtype=torch.float32).reshape(1)
        return torch.cat([gs.to(device), rest.to(device)])

    def _kw(self) -> dict:
        return dict(b1=self.b1, b2=self.b2, eps=self.eps, wd=self.weight_decay)

    def update(self, grads, state: AdamState, params=None):
        """Transformation path (returns an update tree): the plain math on every leaf."""
        if params is None:
            raise ValueError("FusedAdamW.update requires params (AdamW decays weights).")
        flat_p = tree_leaves(params)
        if not flat_p:
            return params, self._next_state(state)
        scalars = self._scalars(state.count, 1.0, flat_p[0].device)
        flat_ms, flat_vs = self._flat_scales(state, len(flat_p))
        out = [adamw_leaf_scaled_reference(p, m, v, g, scalars, ms, vs, **self._kw())
               for p, m, v, g, ms, vs in zip(flat_p, tree_leaves(state.mu),
                                             tree_leaves(state.nu), tree_leaves(grads),
                                             flat_ms, flat_vs)]
        updates = [(o[0].float() - p.float()).to(p.dtype) for o, p in zip(out, flat_p)]
        fields = {"mu": tree_unflatten(state.mu, [o[1] for o in out]),
                  "nu": tree_unflatten(state.nu, [o[2] for o in out])}
        for i, name in ((3, "mu_scale"), (4, "nu_scale")):
            if getattr(state, name, None) is not None:
                fields[name] = tree_unflatten(getattr(state, name), [o[i] for o in out])
        return tree_unflatten(params, updates), self._next_state(state, **fields)

    def fused_apply(self, grads, state: AdamState, params, grad_scale=1.0, groups=None):
        """Single-pass apply, IN PLACE → ``(params, state)``. ``grad_scale`` (a float or
        a 0-d tensor on the params' device) multiplies every gradient in the same pass.
        ``groups`` (per leaf, ``tree_leaves`` order): the process group over which a
        leaf is split (its fp8 moments' amaxes are taken over it), or None."""
        flat_p = tree_leaves(params)
        if not flat_p:
            return params, self._next_state(state)
        scalars = self._scalars(state.count, grad_scale, flat_p[0].device)
        kernel, plain, scaled = ([], [], [], []), [], []
        flat_ms, flat_vs = self._flat_scales(state, len(flat_p))
        groups = groups or [None] * len(flat_p)
        for leaf, ms, vs, group in zip(zip(flat_p, tree_leaves(state.mu), tree_leaves(state.nu),
                                           tree_leaves(grads)), flat_ms, flat_vs, groups):
            if ms is not None or vs is not None:
                scaled.append((*leaf, ms, vs, group))
            elif (self.use_kernel is not False and leaf[0].numel() % _LANES == 0
                  and leaf[0].numel()):
                for column, t in zip(kernel, leaf):
                    column.append(t)
            else:
                plain.append(leaf)
        adamw_leaves(*kernel, scalars, **self._kw())
        _apply_plain(plain, scalars, self._kw())
        _apply_scaled(scaled, scalars, self._kw())
        return params, self._next_state(state)

    def fused_apply_offloaded(self, grads, state: AdamState, params, grad_scale=1.0,
                              groups=None, chunk_elems: Optional[int] = None,
                              n_buffers: Optional[int] = None):
        """:meth:`fused_apply` over moments held in host memory (``cpu_offload``), IN
        PLACE → ``(params, state)``, the moments staying where they are. Kernel leaves
        stream in chunks of ``chunk_elems`` (default :data:`OFFLOAD_CHUNK_ELEMS`)
        through ``n_buffers`` (default :data:`OFFLOAD_BUFFERS`) staging buffers, one
        launch a chunk; the others fetch their moments whole and store them back."""
        flat_p = tree_leaves(params)
        if not flat_p:
            return params, self._next_state(state)
        dev = flat_p[0].device
        t0 = time.perf_counter()
        scalars = self._scalars(state.count, grad_scale, dev)
        flat_ms, flat_vs = self._flat_scales(state, len(flat_p))
        groups = groups or [None] * len(flat_p)
        streamed: dict = {}  # first-moment dtype -> ([p], [m], [v], [g])
        whole = []
        for leaf, ms, vs, group in zip(zip(flat_p, tree_leaves(state.mu), tree_leaves(state.nu),
                                           tree_leaves(grads)), flat_ms, flat_vs, groups):
            if (ms is None and vs is None and self.use_kernel is not False
                    and leaf[0].numel() % _LANES == 0 and leaf[0].numel()):
                for column, t in zip(streamed.setdefault(leaf[1].dtype, ([], [], [], [])),
                                     leaf):
                    column.append(t)
            else:
                whole.append((*leaf, ms, vs, group))
        stats = {"chunks": 0, "h2d_bytes": 0, "d2h_bytes": 0, "h2d_s": 0.0, "d2h_s": 0.0}
        for columns in streamed.values():
            one = _stream_moments(*columns, scalars, self._kw(), chunk_elems or OFFLOAD_CHUNK_ELEMS,
                                  n_buffers or OFFLOAD_BUFFERS)
            for k in stats:
                stats[k] += one[k]
        for p, m, v, g, ms, vs, group in whole:
            fetched = [None if t is None else t.to(dev, non_blocking=True)
                       for t in (m, v, ms, vs)]
            _apply_scaled([(p, *fetched[:2], g, *fetched[2:], group)], scalars, self._kw())
            for host, new in zip((m, v, ms, vs), fetched):
                if host is not None:
                    host.copy_(new)
        stats["whole_leaves"] = len(whole)
        stats["s"] = time.perf_counter() - t0
        OFFLOAD_STATS.clear()
        OFFLOAD_STATS.update(stats)
        return params, self._next_state(state)


def offload_chunks(sizes, chunk: int) -> list:
    """The offload stream's chunks over leaves of ``sizes`` elements (multiples of 1024),
    in order: per chunk, its pieces ``(leaf, start in the leaf, length, offset in the
    chunk)``; a leaf larger than the room left runs on into the next chunk."""
    chunks, used = [[]], 0
    for i, n in enumerate(sizes):
        start = 0
        while start < n:
            if used == chunk:
                chunks.append([])
                used = 0
            take = min(chunk - used, n - start)
            chunks[-1].append((i, start, take, used))
            used += take
            start += take
    return [c for c in chunks if c]


@torch.no_grad()
def _stream_moments(params, mus, nus, grads, scalars, kw, chunk: int, n_buffers: int) -> dict:
    """AdamW over host-resident moments streamed through the device in chunks (one
    kernel launch a chunk, the parameters and gradients on the device); the moments are
    written back in place. Returns the stream's stats."""
    dev = params[0].device
    m_dtype = mus[0].dtype
    plan = offload_chunks([p.numel() for p in params], chunk)
    size = min(chunk, max(sum(n for _, _, n, _ in c) for c in plan))
    bufs = [(torch.empty(size, dtype=m_dtype, device=dev),
             torch.empty(size, dtype=torch.float32, device=dev)) for _ in range(n_buffers)]
    flat = [(p.view(-1), m.view(-1), v.view(-1), g.view(-1))
            for p, m, v, g in zip(params, mus, nus, grads)]
    moment_bytes = sum(m.numel() * m.element_size() + v.numel() * v.element_size()
                       for m, v in zip(mus, nus))
    stats = {"chunks": len(plan), "h2d_bytes": moment_bytes, "d2h_bytes": moment_bytes,
             "h2d_s": 0.0, "d2h_s": 0.0}
    cuda = dev.type == "cuda"
    if cuda:
        compute = torch.cuda.current_stream(dev)
        h2d, d2h = torch.cuda.Stream(dev), torch.cuda.Stream(dev)
        freed = [None] * n_buffers
        spans = []  # (stat, start event, end event)

        def mark(stream):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(stream)
            return ev
    for c, pieces in enumerate(plan):
        mb, vb = bufs[c % n_buffers]
        if cuda:
            with torch.cuda.stream(h2d):
                if freed[c % n_buffers] is not None:
                    h2d.wait_event(freed[c % n_buffers])
                t0 = mark(h2d)
                for i, a, n, off in pieces:
                    mb[off:off + n].copy_(flat[i][1][a:a + n], non_blocking=True)
                    vb[off:off + n].copy_(flat[i][2][a:a + n], non_blocking=True)
                loaded = mark(h2d)
                spans.append(("h2d_s", t0, loaded))
            compute.wait_event(loaded)
        else:
            for i, a, n, off in pieces:
                mb[off:off + n].copy_(flat[i][1][a:a + n])
                vb[off:off + n].copy_(flat[i][2][a:a + n])
        adamw_leaves([flat[i][0][a:a + n] for i, a, n, _ in pieces],
                     [mb[off:off + n] for _, _, n, off in pieces],
                     [vb[off:off + n] for _, _, n, off in pieces],
                     [flat[i][3][a:a + n] for i, a, n, _ in pieces], scalars, **kw)
        if cuda:
            updated = mark(compute)
            with torch.cuda.stream(d2h):
                d2h.wait_event(updated)
                t0 = mark(d2h)
                for i, a, n, off in pieces:
                    flat[i][1][a:a + n].copy_(mb[off:off + n], non_blocking=True)
                    flat[i][2][a:a + n].copy_(vb[off:off + n], non_blocking=True)
                freed[c % n_buffers] = mark(d2h)
                spans.append(("d2h_s", t0, freed[c % n_buffers]))
        else:
            for i, a, n, off in pieces:
                flat[i][1][a:a + n].copy_(mb[off:off + n])
                flat[i][2][a:a + n].copy_(vb[off:off + n])
    if cuda:
        # The host moments are the state's from here on, and the staging buffers go back
        # to the allocator: both need every copy done.
        d2h.synchronize()
        compute.wait_stream(d2h)
        for key, start, end in spans:
            stats[key] += start.elapsed_time(end) / 1e3
    return stats


def fused_adamw(learning_rate: Union[float, Callable] = 1e-3, b1: float = 0.9,
                b2: float = 0.999, eps: float = 1e-8, weight_decay: float = 1e-4,
                mu_dtype=None, nu_dtype=None, use_kernel: Optional[bool] = None) -> FusedAdamW:
    """``adamw``-shaped constructor for the fused optimizer."""
    return FusedAdamW(learning_rate=learning_rate, b1=b1, b2=b2, eps=eps,
                      weight_decay=weight_decay, mu_dtype=mu_dtype, nu_dtype=nu_dtype,
                      use_kernel=use_kernel)
