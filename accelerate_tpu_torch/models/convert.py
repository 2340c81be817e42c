"""Params conversion between the JAX llama params (as numpy arrays) and the port's.

The JAX package keeps fp32 master weights and casts projections and the embedding to
``cfg.dtype`` at each use. The port casts at use too, so it may store them either way:
``params_from_jax`` stores them in ``cfg.dtype`` by default (serving: the same rounding,
half the memory) or in ``master_dtype`` (training keeps fp32 masters); norm gammas and
q/k/v biases stay fp32. ``scan_layers`` params (every leaf stacked on a leading layer
axis) are unstacked into the per-layer list the port uses; ``params_to_numpy`` goes back,
stacked or not, so trained params can be held against the JAX pytree.

A quantized leaf (the JAX ``QuantizedWeight`` as ``jax.tree.map(np.asarray, params)``
leaves it: numpy ``data`` and ``scales`` beside ``shape``, ``scheme`` and
``block_size``) is recognised by those attributes and carried across as the port's
:class:`ops.quantization.QuantizedWeight`, its codes (int8 or uint8) and fp32 scales
unchanged — never cast to the weight dtype. ``params_to_numpy`` gives it back as a
``QuantizedWeight`` of numpy arrays, in unstacked layers only (JAX quantizes 2-D leaves,
never the 3-D ``scan_layers`` stacks).

Under a process mesh (``mesh=``, with ``specs`` defaulting to ``llama.partition_specs``)
``params_from_jax`` gives this rank's shards, sliced from the numpy leaves before any
tensor is made; ``params_to_numpy`` gathers the shards back into whole arrays (a
collective: every rank calls it), so whole pytrees can be compared.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.quantization import QuantizedWeight
from ..parallel.tp import apply_tensor_parallel, gather_tensor_parallel
from ..utils.device import resolve_device
from .llama import PROJECTIONS, LlamaConfig, check_supported, partition_specs

__all__ = ["params_from_jax", "params_to", "params_to_numpy"]

_FP32_LEAVES = ("ln_attn", "ln_mlp", "ln_attn_post", "ln_mlp_post", "bq", "bk", "bv")


_QUANT_FIELDS = ("data", "scales", "shape", "scheme", "block_size")


def _is_quantized(leaf) -> bool:
    return all(hasattr(leaf, f) for f in _QUANT_FIELDS)


def _tensor(arr, dtype: torch.dtype, device: torch.device):
    """A float leaf as a tensor in ``dtype``; a quantized leaf as the port's
    ``QuantizedWeight`` with its codes and scales as they are."""
    if _is_quantized(arr):
        return QuantizedWeight(
            torch.from_numpy(np.array(arr.data)),  # int8 or uint8 codes, a writable copy
            torch.from_numpy(np.array(arr.scales, np.float32)),
            tuple(int(d) for d in arr.shape), str(arr.scheme), int(arr.block_size),
        ).to(device)
    host = torch.from_numpy(np.array(arr, np.float32))  # a writable copy
    return host.to(device=device, dtype=dtype)


def params_from_jax(np_params: dict, cfg: LlamaConfig, device=None,
                    master_dtype=None, mesh=None, specs=None) -> dict:
    """The port's params from the JAX llama params pytree with numpy leaves
    (``jax.tree.map(np.asarray, params)``), stacked or unstacked layers, on ``device``
    (default CUDA; raises when CUDA is absent and no CPU was asked for). Projections,
    the embedding and the head are stored in ``master_dtype`` (default ``cfg.dtype``);
    quantized leaves keep their codes and scales. With ``mesh``: this rank's shards
    under ``specs`` (default ``llama.partition_specs(cfg)``)."""
    check_supported(cfg)
    dev = resolve_device(device)
    weight_dtype = master_dtype or cfg.dtype
    layers = np_params["layers"]
    if isinstance(layers, dict):  # scan_layers: leaves stacked on a leading layer axis
        layers = [{k: v[i] for k, v in layers.items()} for i in range(cfg.n_layers)]
    if mesh is not None:
        if any(_is_quantized(v) for layer in layers for v in layer.values()):
            raise NotImplementedError("sharding quantized leaves is not ported")
        sharded = apply_tensor_parallel({**np_params, "layers": layers}, mesh,
                                        specs if specs is not None else partition_specs(cfg))
        np_params, layers = sharded, sharded["layers"]
    out_layers = []
    for layer in layers:
        out = {}
        for name, arr in layer.items():
            if name in PROJECTIONS:
                out[name] = _tensor(arr, weight_dtype, dev)
            elif name in _FP32_LEAVES:
                out[name] = _tensor(arr, torch.float32, dev)
            else:
                raise NotImplementedError(f"layer leaf {name!r} is not ported yet")
        out_layers.append(out)
    params = {
        "embed": _tensor(np_params["embed"], weight_dtype, dev),
        "layers": out_layers,
        "ln_f": _tensor(np_params["ln_f"], torch.float32, dev),
    }
    if "lm_head" in np_params:
        params["lm_head"] = _tensor(np_params["lm_head"], weight_dtype, dev)
    return params


def params_to(params: dict, device) -> dict:
    """A copy of ``params`` on ``device`` (same dtypes; quantized leaves included)."""
    dev = resolve_device(device)
    out = {k: v.to(dev) for k, v in params.items() if k != "layers"}
    out["layers"] = [{k: v.to(dev) for k, v in layer.items()} for layer in params["layers"]]
    return out


def _numpy(t):
    if isinstance(t, QuantizedWeight):
        return QuantizedWeight(_numpy(t.data), _numpy(t.scales), t.shape, t.scheme,
                               t.block_size)
    t = t.detach().to("cpu", copy=True)  # never a view of a leaf the step updates
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def params_to_numpy(params: dict, stacked: bool = False, mesh=None, specs=None) -> dict:
    """The JAX pytree layout of the port's params, with numpy leaves (bf16 leaves as
    fp32; a quantized leaf as a ``QuantizedWeight`` of numpy codes and scales): layers
    as a list of dicts, or ``stacked`` as one dict of ``[L, ...]`` arrays
    (``scan_layers``). With ``mesh``: the whole leaves gathered from every rank's
    shards under ``specs`` (a collective; ``specs`` as given to
    ``params_from_jax``)."""
    if mesh is not None:
        if specs is None:
            raise ValueError("params_to_numpy(mesh=...) needs the specs the params were "
                             "sharded with")
        params = gather_tensor_parallel(params, mesh, specs)
    out = {k: _numpy(v) for k, v in params.items() if k != "layers"}
    layers = [{k: _numpy(v) for k, v in layer.items()} for layer in params["layers"]]
    if stacked and any(isinstance(v, QuantizedWeight)
                       for layer in layers for v in layer.values()):
        raise NotImplementedError("stacked layers of quantized leaves")
    out["layers"] = ({k: np.stack([layer[k] for layer in layers]) for k in layers[0]}
                     if stacked else layers)
    return out
