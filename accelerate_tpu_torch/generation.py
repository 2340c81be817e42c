"""Sampling: decode-time knobs and the filtered categorical draw.

Counterpart of ``GenerationConfig``, ``filtered_logits`` and ``sampling_core`` in
``accelerate_tpu/generation.py``. JAX threads ``jax.random`` keys; the port draws
from ``torch.Generator``s. The two give different numbers for the same seed, so a
sampled token stream matches the JAX one in distribution, not draw for draw.

The draw is Gumbel-max over the filtered logits (what ``jax.random.categorical``
does). Its noise comes from a CPU generator and is then moved to the logits' device,
so the same generator state draws the same token on the CPU and on the card.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

__all__ = ["GenerationConfig", "filtered_logits", "sampling_core", "emission_generator"]


@dataclasses.dataclass(frozen=True)
class GenerationConfig:
    """Decode-time knobs (the transformers ``GenerationConfig`` analog)."""

    max_new_tokens: int = 128
    temperature: float = 0.0  # 0.0 → greedy (argmax)
    top_k: int = 0            # 0 → disabled
    top_p: float = 1.0        # 1.0 → disabled
    eos_token_id: Optional[int] = None
    pad_token_id: int = 0


def filtered_logits(logits: torch.Tensor, temperature, top_p, top_k: int,
                    apply_top_p: bool = True) -> torch.Tensor:
    """Temperature / top-k / top-p filtered logits [.., V] fp32 (filtered entries -inf).
    Top-p keeps the smallest prefix of the sorted distribution whose cumulative
    probability reaches ``top_p`` (always keeping the best token)."""
    logits = logits.float() / temperature
    if top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, -torch.inf, logits)
    if apply_top_p:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        keep_sorted = cum - probs < top_p
        threshold = torch.where(keep_sorted, sorted_logits, torch.inf).amin(
            dim=-1, keepdim=True)
        logits = torch.where(logits < threshold, -torch.inf, logits)
    return logits


def sampling_core(logits: torch.Tensor, generator: torch.Generator, temperature, top_p,
                  top_k: int, apply_top_p: bool = True) -> torch.Tensor:
    """One categorical draw per row of ``logits`` [.., V] from the filtered
    distribution → int64 token ids [..]. ``generator`` is a CPU generator: the Gumbel
    noise is drawn on the CPU and moved to the logits' device.

    The nucleus filter runs whenever ``apply_top_p`` is true, at ``top_p = 1.0`` too,
    as the JAX engine's draw does: where the fp32 cumulative sum reaches 1.0 before the
    tail ends, the tail tokens past that point are masked on both sides."""
    filt = filtered_logits(logits, temperature, top_p, top_k, apply_top_p)
    u = torch.rand(filt.shape, generator=generator, dtype=torch.float32)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))
    return torch.argmax(filt + gumbel.to(filt.device), dim=-1)


def emission_generator(seed: int, index: int) -> torch.Generator:
    """The CPU generator for emission ``index`` of a request seeded with ``seed`` — a
    fixed per-emission schedule, so a request's draws never depend on what else runs
    beside it."""
    state = np.random.SeedSequence([int(seed), int(index)]).generate_state(1, np.uint32)
    return torch.Generator().manual_seed(int(state[0]))
