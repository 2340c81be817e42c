"""LoRA fine-tuning helpers: the port's counterpart of ``accelerate_tpu/models/lora.py``.

Adaptation is a property of the params tree: ``LlamaConfig(lora_rank=r)`` makes
``llama.init_params`` add ``{name}_lora_a``/``{name}_lora_b`` leaves beside each targeted
projection, and the forward adds the low-rank delta ``(x @ A) @ B * alpha / rank``
(``llama._proj_l``); the adapted weight is never made.

- :func:`add_adapters` attaches fresh adapters to an existing params tree (a loaded
  base checkpoint).
- :func:`lora_mask` — a bool tree, True on adapter leaves.
- :func:`lora_optimizer` — ``optim.multi_transform`` sending the base leaves to
  ``set_to_zero``: optimizer state exists only for the adapters, and the train step
  takes no gradient for the frozen base (``Accelerator.build_train_step`` reads
  ``frozen_leaves``), which also keeps the dtype it came in.
- :func:`merge_lora` / :func:`merge_lora_trees` fold the adapters into the base weights.
- :func:`only_lora` / :func:`load_lora` — an adapter-only checkpoint. Its keys are
  ``jax.tree_util.keystr`` strings (``['layers'][0]['wq_lora_a']``), so a file saved by
  either package loads in the other.

The port's layers are always a per-layer list (``convert.params_from_jax`` unstacks
scanned params); :func:`merge_lora_trees` also takes a layer of stacked ``[L, ...]``
leaves.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch

from ..optim import multi_transform, set_to_zero
from ..utils.tree import keystr, tree_leaves_with_path, tree_map_with_path

__all__ = [
    "add_adapters",
    "lora_mask",
    "lora_optimizer",
    "merge_lora",
    "merge_lora_trees",
    "only_lora",
    "load_lora",
]

_LORA_MARKERS = ("_lora_a", "_lora_b")


def _is_lora_path(path) -> bool:
    return any(isinstance(k, str) and k.endswith(_LORA_MARKERS) for k in path)


def add_adapters(params: dict, cfg, generator: Optional[torch.Generator] = None) -> dict:
    """A new params tree with ``{name}_lora_a`` (A ~ N(0, 1/d_in)) and
    ``{name}_lora_b`` (zeros) fp32 leaves next to each target of ``cfg.lora_targets``
    (the base leaves are shared, not copied). The forward equals the base model's until
    training moves B off zero. ``generator`` (default: seeded with 0 on the params'
    device) draws the A factors."""
    from .llama import _lora_target_names

    if cfg.lora_rank <= 0:
        raise ValueError("add_adapters requires cfg.lora_rank > 0")
    names = _lora_target_names(cfg)
    r = cfg.lora_rank
    layers = params["layers"]
    if generator is None:
        generator = torch.Generator(device=layers[0][names[0]].device).manual_seed(0)

    def one(layer: dict) -> dict:
        out = dict(layer)
        for name in names:
            if f"{name}_lora_a" in layer:
                raise ValueError(f"params already carry adapters for {name!r}")
            w = layer[name]
            shape, dev = tuple(w.shape), w.device
            out[f"{name}_lora_a"] = torch.randn((*shape[:-1], r), generator=generator,
                                                device=dev) / math.sqrt(shape[-2])
            out[f"{name}_lora_b"] = torch.zeros((*shape[:-2], r, shape[-1]), device=dev)
        return out

    return {**params, "layers": [one(layer) for layer in layers]}


def lora_mask(params: Any) -> Any:
    """Bool tree (the structure of ``params``): True exactly on adapter leaves."""
    return tree_map_with_path(lambda path, _: _is_lora_path(path), params)


def lora_optimizer(tx):
    """``tx`` for the adapter leaves only: ``multi_transform`` sends the base leaves to
    ``set_to_zero`` (no optimizer state for them; no gradient taken in the train step).
    Pass the result to ``Accelerator.create_train_state`` as usual."""

    def labels(params):
        return tree_map_with_path(
            lambda path, _: "adapter" if _is_lora_path(path) else "frozen", params)

    return multi_transform({"adapter": tx, "frozen": set_to_zero()}, labels)


def only_lora(params: Any) -> dict:
    """``{keystr(path): leaf}`` of just the adapter leaves (save these apart from the
    frozen base)."""
    return {keystr(path): leaf for path, leaf in tree_leaves_with_path(params)
            if _is_lora_path(path)}


def load_lora(params: Any, adapters: dict) -> Any:
    """Inverse of :func:`only_lora`: the adapter leaves replaced by the checkpoint's
    (tensors, or arrays made tensors on the leaf's device and dtype). A missing or an
    extra key raises, as does a shape that differs."""
    remaining = dict(adapters)

    def sub(path, leaf):
        if not _is_lora_path(path):
            return leaf
        key = keystr(path)
        if key not in remaining:
            raise KeyError(f"adapter checkpoint is missing {key}")
        new = remaining.pop(key)
        if tuple(new.shape) != tuple(leaf.shape):
            raise ValueError(f"{key}: checkpoint shape {tuple(new.shape)} != params "
                             f"{tuple(leaf.shape)}")
        return torch.as_tensor(new).to(device=leaf.device, dtype=leaf.dtype)

    out = tree_map_with_path(sub, params)
    if remaining:
        raise KeyError(f"adapter checkpoint has extra entries: {sorted(remaining)[:3]}")
    return out


def merge_lora_trees(layer: dict, cfg) -> dict:
    """One layer dict with its adapters folded into the base weights (``W + A @ B *
    alpha / rank`` in fp32, then W's dtype); the adapter leaves are dropped."""
    scale = cfg.lora_alpha / cfg.lora_rank
    merged = {}
    for name, leaf in layer.items():
        if name.endswith(_LORA_MARKERS):
            continue
        a = layer.get(f"{name}_lora_a")
        if a is not None:
            b = layer[f"{name}_lora_b"]
            delta = torch.einsum("...ir,...ro->...io", a.float(), b.float()) * scale
            leaf = (leaf + delta.to(leaf.dtype)).to(leaf.dtype)
        merged[name] = leaf
    return merged


def merge_lora(params: dict, cfg):
    """Every layer's adapters folded into its base weights → ``(plain params, cfg with
    lora_rank=0)``: a base-architecture checkpoint for serving, export, quantization."""
    if cfg.lora_rank <= 0:
        return params, cfg
    out = {**params, "layers": [merge_lora_trees(layer, cfg) for layer in params["layers"]]}
    return out, dataclasses.replace(cfg, lora_rank=0)
