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

``mu_dtype`` may be fp32 (default: the param's type) or bf16; the second moment stays
fp32. fp8 moments (the JAX ``ScaledAdamState``) are not ported and raise.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Any, Callable, Optional, Union

import torch

from ..optim import AdamState, bias_correction, scale_by
from ..utils.tree import tree_leaves, tree_map, tree_unflatten
from . import _build

__all__ = ["FusedAdamW", "fused_adamw", "adamw_leaf_reference", "adamw_leaves"]

_LANES = 1024  # leaves whose size is a multiple of this take the kernel
_M_CODE = {torch.float32: 0, torch.bfloat16: 1}


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
        if self.mu_dtype not in (None, torch.float32, torch.bfloat16):
            raise NotImplementedError(
                f"mu_dtype={self.mu_dtype}: only fp32 and bf16 first moments are ported "
                "(fp8 moments, the JAX ScaledAdamState, are not)")
        if self.nu_dtype not in (None, torch.float32):
            raise NotImplementedError(
                f"nu_dtype={self.nu_dtype}: the second moment is kept in fp32")

    def init(self, params) -> AdamState:
        mu = tree_map(lambda p: torch.zeros_like(p, dtype=self.mu_dtype or p.dtype), params)
        nu = tree_map(lambda p: torch.zeros_like(p, dtype=self.nu_dtype or p.dtype), params)
        return AdamState(count=0, mu=mu, nu=nu)

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
            return params, AdamState(state.count + 1, state.mu, state.nu)
        scalars = self._scalars(state.count, 1.0, flat_p[0].device)
        out = [adamw_leaf_reference(p, m, v, g, scalars, **self._kw())
               for p, m, v, g in zip(flat_p, tree_leaves(state.mu), tree_leaves(state.nu),
                                     tree_leaves(grads))]
        updates = [(n.float() - p.float()).to(p.dtype) for (n, _, _), p in zip(out, flat_p)]
        return (tree_unflatten(params, updates),
                AdamState(count=state.count + 1, mu=tree_unflatten(state.mu, [o[1] for o in out]),
                          nu=tree_unflatten(state.nu, [o[2] for o in out])))

    def fused_apply(self, grads, state: AdamState, params, grad_scale=1.0):
        """Single-pass apply, IN PLACE → ``(params, state)``. ``grad_scale`` (a float or
        a 0-d tensor on the params' device) multiplies every gradient in the same pass."""
        flat_p = tree_leaves(params)
        if not flat_p:
            return params, AdamState(state.count + 1, state.mu, state.nu)
        scalars = self._scalars(state.count, grad_scale, flat_p[0].device)
        kernel, plain = ([], [], [], []), []
        for leaf in zip(flat_p, tree_leaves(state.mu), tree_leaves(state.nu),
                        tree_leaves(grads)):
            if self.use_kernel is not False and leaf[0].numel() % _LANES == 0 and leaf[0].numel():
                for column, t in zip(kernel, leaf):
                    column.append(t)
            else:
                plain.append(leaf)
        adamw_leaves(*kernel, scalars, **self._kw())
        _apply_plain(plain, scalars, self._kw())
        return params, AdamState(count=state.count + 1, mu=state.mu, nu=state.nu)


def fused_adamw(learning_rate: Union[float, Callable] = 1e-3, b1: float = 0.9,
                b2: float = 0.999, eps: float = 1e-8, weight_decay: float = 1e-4,
                mu_dtype=None, nu_dtype=None, use_kernel: Optional[bool] = None) -> FusedAdamW:
    """``adamw``-shaped constructor for the fused optimizer."""
    return FusedAdamW(learning_rate=learning_rate, b1=b1, b2=b2, eps=eps,
                      weight_decay=weight_decay, mu_dtype=mu_dtype, nu_dtype=nu_dtype,
                      use_kernel=use_kernel)
