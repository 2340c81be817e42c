"""Llama-family decoder LM: config, params, the training forward and loss, and the
cached (serving) forwards.

Counterpart of ``accelerate_tpu/models/llama.py``: the same config fields and named
configs, the same param names and shapes (dict params, weight matrices laid out
``[d_in, d_out]`` so ``x @ w``), the training path — ``forward_hidden``, ``forward``,
``loss_fn`` (next-token CE, chunked for large vocabularies, packed ``segment_ids``,
sliding windows alternating by ``window_every``), with each block checkpointed when
``cfg.remat`` — and the cached forwards — ``forward_cached`` (single-row prefill over a
dense cache), ``forward_slots`` (per-lane positions, dense or paged cache) and
``forward_slots_paged``.

Params are a plain dict: ``{"embed" [V,D], "layers": [per-layer dict, ...], "ln_f" [D],
"lm_head" [D,V]}``. Every weight is cast to ``cfg.dtype`` at its use, as in the JAX
code, so params may be held in ``cfg.dtype`` (serving: ``init_params`` and
``convert.params_from_jax`` store them so) or as fp32 masters (training); norm gammas
and q/k/v biases stay fp32. Layers are always a per-layer list
(``convert.params_from_jax`` unstacks ``scan_layers`` params; the unstacked layers run
the same math as the JAX scan, the window alternation included).

Projection leaves may be :class:`ops.quantization.QuantizedWeight` (int8 / int4 / nf4
weight-only, from ``ops.quantization.load_and_quantize_model``): ``_proj`` sends them
through ``quant_matmul``, as the JAX ``_proj`` does — int8 through the hand-written
kernel on the card. A quantized ``embed`` or ``lm_head`` raises ``NotImplementedError``
(the JAX forwards cannot run one either; quantize with ``skip_modules=["embed",
"lm_head"]``).

Tensor parallelism (Megatron layout, ``partition_specs``): under a process mesh with a
``tp`` axis (``parallel.mesh.mesh_context``, which ``Accelerator.build_train_step``
provides) the params are this rank's shards (``parallel.tp.apply_tensor_parallel``) and
the training forward reads them as such: ``H/tp`` query and ``K/tp`` kv heads (whole
GQA groups), the column-parallel ``wq/wk/wv/w_gate/w_up`` behind ``copy_to_group``,
the row-parallel ``wo/w_down`` followed by ``reduce_from_group``, the vocab-parallel
embedding, and norms replicated. ``loss_fn`` then returns the global masked mean over
the batch ranks' tokens on every rank (its gradient scaled for the train step's average
over the batch ranks: ``parallel.tp.replica_sum``), and
``forward``/``head_logits`` give this rank's vocab slice of the logits. The cached
(serving) forwards take whole params.

ZeRO-3 (``parallel/fsdp.py``): ``loss_fn`` gathers ``FsdpShard`` leaves itself
(``gathers_fsdp_shards``). A layer's leaves are gathered at the start of the block,
inside its remat unit, so the forward holds one layer's whole weights at a time and the
recompute in the backward gathers again (torch FSDP's schedule); the projections (and
biases and adapters) are cast to ``cfg.dtype`` before the gather, as they would be at
their use; the embedding, the head and ``ln_f`` are gathered where they are used.

The one-request API — :func:`generate` (prefill, then decode steps replayed from a CUDA
graph on the card through ``generation.generate_loop``), :func:`score` and
:func:`perplexity` — :func:`forward_slots_multi`, the serving engine's N-step
super-step, and :func:`forward_slots_spec_multi`, its N-round speculative super-step,
follow the JAX functions of the same names.

LoRA (``lora_rank > 0``): ``init_params`` adds ``{name}_lora_a`` (A ~ N(0, 1/d_in)) and
``{name}_lora_b`` (zeros) fp32 leaves beside each projection of ``lora_targets``, and
``_proj_l`` adds ``((h @ A) @ B) * lora_alpha / lora_rank`` in ``cfg.dtype`` on every path
(training, cached, slots, super-steps, ``generate``); the adapted weight is never
made (``models/lora.py``). Under tp, A takes the base's row spec and B its column spec;
the replicated factor (A of a column-parallel projection, B of a row-parallel one) is
used behind ``copy_to_group``, so its gradient sums over the group, and the delta of a
row-parallel projection is added before ``reduce_from_group``, a partial sum like the
base product.

fp8 (``use_fp8``): every dense projection is ``ops.fp8.fp8_dot(h, w, cfg.fp8_format)``
(the process recipe's format when None), its amaxes taken over every rank of a mesh
(tp shards and batch ranks alike, as GSPMD's amax is global); a quantized leaf keeps
``quant_matmul``.

Not supported in this slice (raise ``NotImplementedError``): ``moe_experts > 0``.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Optional

import torch
import torch.nn.functional as F

from ..ops.fp8 import fp8_dot
from ..ops.quantization import QuantizedWeight, quant_matmul
from ..optim import scale_by
from ..parallel.fsdp import gathers_fsdp_shards, materialize
from ..parallel.mesh import P, current_mesh
from ..parallel.tp import (all_reduce, copy_to_group, group_rank_size, reduce_from_group,
                           vocab_parallel_embedding)
from ..utils.constants import BATCH_AXES, FSDP_AXIS, TENSOR_AXIS
from ..utils.device import resolve_device
from ..utils.tree import tree_leaves
from .common import (_softcap, attention_dispatch, ce_sum_dispatch, multi_step_decode,
                     put_or_drop, remat_wrap, resolve_loss_chunk, spec_multi_step_decode)
from .common import kv_planes as _kv_planes
from .common import paged_attention_dispatch as _paged_attention
from .common import paged_kv_planes as _paged_kv_planes
from .common import paged_write_coords as _paged_write_coords
from .common import read_kv as _read_cache
from .common import write_kv as _write_cache
from .common import write_kv_paged as _write_cache_paged

__all__ = [
    "LlamaConfig",
    "CONFIGS",
    "init_params",
    "partition_specs",
    "num_params",
    "packed_target_mask",
    "segment_positions",
    "segment_mask",
    "forward_hidden",
    "forward",
    "loss_fn",
    "head_logits",
    "init_cache",
    "init_paged_cache",
    "forward_cached",
    "forward_slots",
    "forward_slots_paged",
    "forward_slots_multi",
    "forward_slots_spec_multi",
    "score",
    "perplexity",
    "generate",
]


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    d_model: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    d_ff: int = 14336
    max_seq: int = 8192
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    dtype: Any = torch.bfloat16
    tie_embeddings: bool = False
    attn_impl: str = "auto"
    remat: bool = True
    remat_policy: str = "full"
    remat_prevent_cse: Optional[bool] = None
    scan_layers: bool = False
    scan_unroll: int = 1
    use_fp8: bool = False
    fp8_format: Optional[str] = None
    moe_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01
    loss_chunk: int = 0
    loss_impl: str = "auto"
    # int8 KV cache: int8 k/v with a per-(token, kv-head) fp32 scale.
    kv_quant: bool = False
    # Sliding-window attention: position i attends only (i-window, i]. 0 = full causal.
    sliding_window: int = 0
    # Apply the window to every Nth layer only (Gemma-2: even layers banded).
    window_every: int = 1
    # ---- Gemma-family knobs (all default to llama behavior) ----
    head_dim_override: Optional[int] = None
    mlp_act: str = "silu"       # "silu" (SwiGLU) | "gelu" (GeGLU, tanh approximation)
    post_norm: bool = False     # RMSNorm on each sublayer OUTPUT before the residual
    norm_plus_one: bool = False  # RMSNorm weight stored zero-centered: out = x̂·(1 + w)
    embed_scale: bool = False   # multiply token embeddings by sqrt(d_model)
    attn_scale: Optional[float] = None
    attn_softcap: float = 0.0
    final_softcap: float = 0.0
    qkv_bias: bool = False      # Qwen2-style q/k/v biases
    rope_scaling: Optional[str] = None  # None | "llama3" (Llama-3.1 per-band scaling)
    rope_scaling_factor: float = 8.0
    rope_low_freq_factor: float = 1.0
    rope_high_freq_factor: float = 4.0
    rope_original_max: int = 8192
    lora_rank: int = 0
    lora_alpha: float = 16.0
    lora_targets: tuple = ("wq", "wk", "wv", "wo")

    @property
    def head_dim(self) -> int:
        return self.head_dim_override or self.d_model // self.n_heads

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads


CONFIGS = {
    "llama3-8b": LlamaConfig(
        vocab_size=128256, d_model=4096, n_layers=32, n_heads=32, n_kv_heads=8, d_ff=14336
    ),
    "llama3.1-8b": LlamaConfig(
        vocab_size=128256, d_model=4096, n_layers=32, n_heads=32, n_kv_heads=8,
        d_ff=14336, max_seq=131072, rope_scaling="llama3",
    ),
    "llama3-70b": LlamaConfig(
        vocab_size=128256, d_model=8192, n_layers=80, n_heads=64, n_kv_heads=8, d_ff=28672
    ),
    "llama2-7b": LlamaConfig(
        vocab_size=32000, d_model=4096, n_layers=32, n_heads=32, n_kv_heads=32, d_ff=11008,
        rope_theta=10000.0, max_seq=4096,
    ),
    "tiny": LlamaConfig(
        vocab_size=256, d_model=128, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=256,
        max_seq=128, remat=False,
    ),
    "debug": LlamaConfig(
        vocab_size=512, d_model=256, n_layers=4, n_heads=8, n_kv_heads=4, d_ff=512,
        max_seq=512, remat=False,
    ),
    "mistral-7b": LlamaConfig(
        vocab_size=32000, d_model=4096, n_layers=32, n_heads=32, n_kv_heads=8, d_ff=14336,
        rope_theta=10000.0, max_seq=32768, sliding_window=4096,
    ),
    "gemma2-9b": LlamaConfig(
        vocab_size=256000, d_model=3584, n_layers=42, n_heads=16, n_kv_heads=8,
        d_ff=14336, head_dim_override=256, rope_theta=10000.0, max_seq=8192,
        tie_embeddings=True, mlp_act="gelu", post_norm=True, norm_plus_one=True,
        embed_scale=True, attn_scale=224.0**-0.5, attn_softcap=50.0, final_softcap=30.0,
        sliding_window=4096, window_every=2, norm_eps=1e-6,
    ),
    "qwen2-7b": LlamaConfig(
        vocab_size=152064, d_model=3584, n_layers=28, n_heads=28, n_kv_heads=4,
        d_ff=18944, rope_theta=1e6, max_seq=32768, qkv_bias=True, norm_eps=1e-6,
    ),
    "mixtral-8x7b": LlamaConfig(
        vocab_size=32000, d_model=4096, n_layers=32, n_heads=32, n_kv_heads=8, d_ff=14336,
        rope_theta=1e6, max_seq=32768, moe_experts=8, moe_top_k=2,
    ),
    "moe-tiny": LlamaConfig(
        vocab_size=256, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=128,
        max_seq=128, remat=False, moe_experts=4, moe_top_k=2,
    ),
}

#: Weight leaves stored in ``cfg.dtype``; every other layer leaf stays fp32.
PROJECTIONS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


#: Row-parallel projections (input dim split over tp); the others are column-parallel.
ROW_PARALLEL = ("wo", "w_down")


def check_supported(cfg: LlamaConfig) -> None:
    """Raise ``NotImplementedError`` for config knobs this slice does not port."""
    if cfg.moe_experts > 0:
        raise NotImplementedError(f"moe_experts={cfg.moe_experts!r} is not ported yet")


def _lora_target_names(cfg: LlamaConfig) -> tuple:
    """The subset of ``cfg.lora_targets`` that exists as dense projections."""
    unknown = set(cfg.lora_targets) - set(PROJECTIONS)
    if unknown:
        raise ValueError(f"lora_targets {sorted(unknown)} are not dense projection names")
    return tuple(t for t in cfg.lora_targets if t in PROJECTIONS)


# --------------------------------------------------------------------------------- params
def _layer_params(cfg: LlamaConfig, g: torch.Generator, device) -> dict:
    D, H, K, hd, F_ = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff
    s_in = 1.0 / math.sqrt(D)
    s_ff = 1.0 / math.sqrt(F_)

    def normal(shape, scale):
        w = torch.randn(shape, generator=g, device=device, dtype=torch.float32) * scale
        return w.to(cfg.dtype)

    norm_init = torch.zeros if cfg.norm_plus_one else torch.ones
    params = {
        "ln_attn": norm_init(D, dtype=torch.float32, device=device),
        "wq": normal((D, H * hd), s_in),
        "wk": normal((D, K * hd), s_in),
        "wv": normal((D, K * hd), s_in),
        "wo": normal((H * hd, D), s_in),
        "ln_mlp": norm_init(D, dtype=torch.float32, device=device),
    }
    if cfg.post_norm:
        params["ln_attn_post"] = norm_init(D, dtype=torch.float32, device=device)
        params["ln_mlp_post"] = norm_init(D, dtype=torch.float32, device=device)
    if cfg.qkv_bias:
        params["bq"] = torch.zeros(H * hd, dtype=torch.float32, device=device)
        params["bk"] = torch.zeros(K * hd, dtype=torch.float32, device=device)
        params["bv"] = torch.zeros(K * hd, dtype=torch.float32, device=device)
    params.update({
        "w_gate": normal((D, F_), s_in),
        "w_up": normal((D, F_), s_in),
        "w_down": normal((F_, D), s_ff),
    })
    return params


def init_params(cfg: LlamaConfig, *, generator: Optional[torch.Generator] = None,
                device=None) -> dict:
    """Random params with the JAX ``init_params`` names, shapes and scales, drawn on
    ``device`` (default CUDA; raises when CUDA is absent and no CPU was asked for)
    from ``generator`` (default: a generator on that device seeded with 0)."""
    check_supported(cfg)
    dev = resolve_device(device)
    g = generator if generator is not None else torch.Generator(device=dev).manual_seed(0)
    scale = 1.0 / math.sqrt(cfg.d_model)
    params = {
        "embed": (torch.randn((cfg.vocab_size, cfg.d_model), generator=g, device=dev)
                  * scale).to(cfg.dtype),
        "layers": [_layer_params(cfg, g, dev) for _ in range(cfg.n_layers)],
        "ln_f": (torch.zeros if cfg.norm_plus_one else torch.ones)(
            cfg.d_model, dtype=torch.float32, device=dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = (torch.randn((cfg.d_model, cfg.vocab_size), generator=g,
                                         device=dev) * scale).to(cfg.dtype)
    if cfg.lora_rank > 0:  # drawn after the base, so its stream is the same with or without
        from .lora import add_adapters

        params = add_adapters(params, cfg, generator=g)
    return params


def partition_specs(cfg: LlamaConfig, pp: bool = False, virtual_stages: int = 1) -> dict:
    """Megatron-layout specs, the structure of the JAX params pytree (a per-layer list,
    or with ``scan_layers`` one dict of stacked specs): column-parallel wq/wk/wv/w_gate/
    w_up split their output dim over ``tp``, row-parallel wo/w_down their input dim;
    the embedding and the head shard the vocab dim over ``(tp, fsdp)``; norms are
    replicated; a LoRA A takes its base's row spec, B its column spec. Pipeline stages
    and MoE are not ported (``NotImplementedError``)."""
    if pp or virtual_stages != 1:
        raise NotImplementedError("pipeline-parallel specs are not ported")
    check_supported(cfg)
    layer = {
        "ln_attn": P(),
        "wq": P(None, TENSOR_AXIS),
        "wk": P(None, TENSOR_AXIS),
        "wv": P(None, TENSOR_AXIS),
        "wo": P(TENSOR_AXIS, None),
        "ln_mlp": P(),
    }
    if cfg.post_norm:
        layer["ln_attn_post"] = P()
        layer["ln_mlp_post"] = P()
    if cfg.qkv_bias:
        layer["bq"] = P(TENSOR_AXIS)
        layer["bk"] = P(TENSOR_AXIS)
        layer["bv"] = P(TENSOR_AXIS)
    layer.update({
        "w_gate": P(None, TENSOR_AXIS),
        "w_up": P(None, TENSOR_AXIS),
        "w_down": P(TENSOR_AXIS, None),
    })
    if cfg.lora_rank > 0:
        for name in _lora_target_names(cfg):
            base = layer[name]
            layer[f"{name}_lora_a"] = P(base[0], None)
            layer[f"{name}_lora_b"] = P(None, base[1])
    if cfg.scan_layers:
        layers: Any = {k: P(None, *v) for k, v in layer.items()}
    else:
        layers = [dict(layer) for _ in range(cfg.n_layers)]
    vocab_axes = (TENSOR_AXIS, FSDP_AXIS)
    specs = {"embed": P(vocab_axes, None), "layers": layers, "ln_f": P()}
    if not cfg.tie_embeddings:
        specs["lm_head"] = P(None, vocab_axes)
    return specs


# ------------------------------------------------------------------------------ layer math
def _rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float,
              plus_one: bool = False) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    g = gamma.float()
    if plus_one:  # Gemma convention: weights stored zero-centered
        g = g + 1.0
    return (normed * g).to(x.dtype)


@functools.lru_cache(maxsize=64)
def _rope_freqs(cfg: LlamaConfig, hd: int, device: torch.device) -> torch.Tensor:
    """Per-band inverse wavelengths, with optional Llama-3.1 context-extension scaling
    (cached per config, head dim and device; callers never write to it)."""
    freqs = 1.0 / (cfg.rope_theta ** (
        torch.arange(0, hd, 2, dtype=torch.float32, device=device) / hd))
    if cfg.rope_scaling is None:
        return freqs
    if cfg.rope_scaling != "llama3":
        raise ValueError(f"rope_scaling={cfg.rope_scaling!r}: expected None or 'llama3'")
    factor = cfg.rope_scaling_factor
    low_wl = cfg.rope_original_max / cfg.rope_low_freq_factor
    high_wl = cfg.rope_original_max / cfg.rope_high_freq_factor
    wavelen = 2.0 * math.pi / freqs
    smooth = (cfg.rope_original_max / wavelen - cfg.rope_low_freq_factor) / (
        cfg.rope_high_freq_factor - cfg.rope_low_freq_factor
    )
    return torch.where(
        wavelen > low_wl,
        freqs / factor,  # long-wavelength (low-freq) bands: fully scaled
        torch.where(
            wavelen < high_wl,
            freqs,  # short-wavelength bands: untouched
            (1.0 - smooth) * freqs / factor + smooth * freqs,  # smooth ramp between
        ),
    )


def _rope(x: torch.Tensor, positions: torch.Tensor, cfg: LlamaConfig) -> torch.Tensor:
    """Rotary embedding in fp32: x [B, S, H, hd], positions [B, S]."""
    freqs = _rope_freqs(cfg, x.shape[-1], x.device)
    angles = positions[..., None].float() * freqs                # [B, S, hd/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _sm_scale(cfg: LlamaConfig) -> float:
    """Softmax scale: 1/sqrt(head_dim) unless the config overrides it."""
    return cfg.attn_scale if cfg.attn_scale is not None else 1.0 / math.sqrt(cfg.head_dim)


def _proj(h: torch.Tensor, w, cfg: LlamaConfig, tp=None) -> torch.Tensor:
    """Projection matmul ``h @ w`` in ``cfg.dtype``; for a quantized weight leaf
    ``quant_matmul`` (the int8 kernel on the card) with a ``cfg.dtype`` result; under
    ``cfg.use_fp8`` ``fp8_dot`` (amaxes over :func:`_fp8_group`)."""
    if isinstance(w, QuantizedWeight):
        return quant_matmul(h, w, out_dtype=cfg.dtype)
    if cfg.use_fp8:
        return fp8_dot(h, w, cfg.fp8_format, group=_fp8_group(tp))
    return h @ w.to(cfg.dtype)


def _fp8_group(tp):
    """The group of an fp8 amax: every rank of a mesh of several (a batch rank holds
    its own rows and a tp rank its own shard, and GSPMD's amax is global over both);
    ``tp`` (None) outside one."""
    mesh = current_mesh()
    if mesh is None or mesh.size == 1:
        return tp
    import torch.distributed as dist

    return dist.group.WORLD


def _dense_leaf(w, name: str):
    """``w``, which must not be quantized (the embedding and the LM head)."""
    if isinstance(w, QuantizedWeight):
        raise NotImplementedError(
            f"a quantized {name!r} leaf is not supported (nor in the JAX forwards): "
            "quantize with skip_modules=['embed', 'lm_head']")
    return w


def _proj_l(h: torch.Tensor, layer: dict, name: str, cfg: LlamaConfig,
            tp=None) -> torch.Tensor:
    """:func:`_proj` of the layer's ``name`` weight plus its LoRA delta ``((h @ A) @ B) *
    alpha / rank`` when the layer has adapters for ``name`` (a row-parallel delta is a
    partial sum: the caller reduces both together)."""
    out = _proj(h, layer[name], cfg, tp)
    if cfg.lora_rank > 0 and f"{name}_lora_a" in layer:
        a, b = layer[f"{name}_lora_a"], layer[f"{name}_lora_b"]
        if name in ROW_PARALLEL:
            b = copy_to_group(b, tp)
        else:
            a = copy_to_group(a, tp)
        delta = (h @ a.to(cfg.dtype)) @ b.to(cfg.dtype)
        out = out + scale_by(cfg.lora_alpha / cfg.lora_rank, delta)
    return out


def _mlp_gate_act(h: torch.Tensor, cfg: LlamaConfig) -> torch.Tensor:
    if cfg.mlp_act == "silu":
        return F.silu(h)
    if cfg.mlp_act == "gelu":  # GeGLU (tanh approximation — Gemma convention)
        return F.gelu(h, approximate="tanh")
    raise ValueError(f"mlp_act={cfg.mlp_act!r}: expected 'silu' or 'gelu'")


def _qkv_proj(h: torch.Tensor, layer: dict, cfg: LlamaConfig, tp=None):
    """q/k/v projections (+ Qwen2-style biases when ``cfg.qkv_bias``)."""
    q = _proj_l(h, layer, "wq", cfg, tp)
    k = _proj_l(h, layer, "wk", cfg, tp)
    v = _proj_l(h, layer, "wv", cfg, tp)
    if cfg.qkv_bias:
        q = q + layer["bq"].to(q.dtype)
        k = k + layer["bk"].to(k.dtype)
        v = v + layer["bv"].to(v.dtype)
    return q, k, v


def _head(params: dict, cfg: LlamaConfig) -> torch.Tensor:
    """The LM head ``[D, V]``: ``embed.T`` when tied, else ``lm_head``."""
    if cfg.tie_embeddings:
        return _dense_leaf(materialize(params["embed"]), "embed").T
    return _dense_leaf(materialize(params["lm_head"]), "lm_head")


def head_logits(x: torch.Tensor, params: dict, cfg: LlamaConfig) -> torch.Tensor:
    """Final hidden → fp32 logits, incl. the Gemma final softcap."""
    head = _head(params, cfg)
    logits = (x @ head.to(cfg.dtype)).float()
    return _softcap(logits, cfg.final_softcap)


def num_params(cfg: LlamaConfig) -> int:
    """Analytic parameter count (the MFU formula's N)."""
    D, F_, V, H, K, hd = (cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.n_heads, cfg.n_kv_heads,
                          cfg.head_dim)
    mlp = 3 * D * F_ if cfg.moe_experts == 0 else cfg.moe_experts * 3 * D * F_ + D * cfg.moe_experts
    per_layer = D * H * hd + 2 * D * K * hd + H * hd * D + mlp + 2 * D
    total = V * D + cfg.n_layers * per_layer + D
    if not cfg.tie_embeddings:
        total += D * V
    return total


# ------------------------------------------------------------------------ training forward
def _attention_xla(q, k, v, mask, cfg: LlamaConfig):
    """Reference attention: q [B,S,H,hd], k/v [B,S,K,hd], mask [B|1,S,S] → [B,S,H,hd].
    GQA stays grouped (the einsums contract against the unrepeated k/v); a masked score
    takes ``finfo.min`` before the fp32 softmax."""
    B, S, H, hd = q.shape
    K = k.shape[2]
    qg = q.reshape(B, S, K, H // K, hd)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k) * _sm_scale(cfg)
    scores = _softcap(scores, cfg.attn_softcap)
    scores = torch.where(mask[:, None, None, :, :], scores, torch.finfo(scores.dtype).min)
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    return torch.einsum("bkgst,btkd->bskgd", probs, v).reshape(B, S, H, hd)


def _attention(q, k, v, mask, cfg: LlamaConfig, segment_ids=None):
    """Family attention through ``common.attention_dispatch`` (flash kernels or the
    grouped einsum above), with the config's window, softcap and scale."""
    return attention_dispatch(
        q, k, v, mask, impl=cfg.attn_impl, sm_scale=_sm_scale(cfg),
        window=cfg.sliding_window, softcap=cfg.attn_softcap, segment_ids=segment_ids,
        xla_attention=lambda q_, k_, v_, m_: _attention_xla(q_, k_, v_, m_, cfg),
    )


def _block(x, layer, positions, mask, cfg: LlamaConfig, segment_ids=None, tp=None):
    """One transformer block (dense MLP; MoE is not ported). ``tp``: the
    tensor-parallel group whose rank holds ``layer``'s shards (``None``: whole)."""
    layer = _gather_layer(layer, cfg)
    B, S, D = x.shape
    n = group_rank_size(tp)[1]
    H, K = cfg.n_heads // n, cfg.n_kv_heads // n  # this rank's heads, whole GQA groups
    p1 = cfg.norm_plus_one
    h = copy_to_group(_rms_norm(x, layer["ln_attn"], cfg.norm_eps, p1), tp)
    q, k, v = _qkv_proj(h, layer, cfg, tp)
    q = _rope(q.reshape(B, S, H, cfg.head_dim), positions, cfg)
    k = _rope(k.reshape(B, S, K, cfg.head_dim), positions, cfg)
    v = v.reshape(B, S, K, cfg.head_dim)
    attn = _attention(q, k, v, mask, cfg, segment_ids).reshape(B, S, H * cfg.head_dim)
    attn_out = reduce_from_group(_proj_l(attn, layer, "wo", cfg, tp), tp)
    if cfg.post_norm:  # Gemma-2: normalize the sublayer OUTPUT before the residual add
        attn_out = _rms_norm(attn_out, layer["ln_attn_post"], cfg.norm_eps, p1)
    x = x + attn_out
    h = copy_to_group(_rms_norm(x, layer["ln_mlp"], cfg.norm_eps, p1), tp)
    gate = _mlp_gate_act(_proj_l(h, layer, "w_gate", cfg, tp), cfg)
    mlp_out = reduce_from_group(
        _proj_l(gate * _proj_l(h, layer, "w_up", cfg, tp), layer, "w_down", cfg, tp), tp)
    if cfg.post_norm:
        mlp_out = _rms_norm(mlp_out, layer["ln_mlp_post"], cfg.norm_eps, p1)
    return x + mlp_out


#: Layer leaves cast to ``cfg.dtype`` at their use (so before an fsdp gather too).
_CAST_AT_USE = PROJECTIONS + ("bq", "bk", "bv")


def _gather_layer(layer: dict, cfg: LlamaConfig) -> dict:
    """The layer's whole leaves from ``FsdpShard`` pieces (``parallel.fsdp.materialize``;
    other leaves as they are), a projection, bias or adapter cast to ``cfg.dtype``
    first unless fp8 quantizes it from its own type."""
    def dtype(name):
        if cfg.use_fp8:
            return None
        return cfg.dtype if name in _CAST_AT_USE or "_lora_" in name else None

    return {k: materialize(v, dtype(k)) for k, v in layer.items()}


def _maybe_remat_block(cfg: LlamaConfig):
    """The block under the config's activation-checkpointing policy."""
    return remat_wrap(_block, remat=cfg.remat, policy=cfg.remat_policy)


def packed_target_mask(segment_ids: torch.Tensor) -> torch.Tensor:
    """Float mask [B, S-1] of valid next-token targets in packed rows: position t's
    target (slot t+1) counts only when it continues the SAME segment and is not pad."""
    seg = segment_ids
    return ((seg[:, 1:] == seg[:, :-1]) & (seg[:, 1:] != 0)).float()


def segment_positions(segment_ids: torch.Tensor) -> torch.Tensor:
    """Per-segment 0-based positions [B, S] of contiguous ``segment_ids`` (0 on pads)."""
    B, S = segment_ids.shape
    idx = torch.arange(S, device=segment_ids.device).expand(B, S)
    change = torch.cat([torch.ones((B, 1), dtype=torch.bool, device=segment_ids.device),
                        segment_ids[:, 1:] != segment_ids[:, :-1]], dim=1)
    starts = torch.cummax(torch.where(change, idx, 0), dim=1).values
    return torch.where(segment_ids != 0, idx - starts, 0)


def segment_mask(segment_ids: torch.Tensor) -> torch.Tensor:
    """Packed-row attention mask [B, S, S]: causal AND same segment AND not padding."""
    S = segment_ids.shape[1]
    causal = torch.tril(torch.ones((S, S), dtype=torch.bool, device=segment_ids.device))[None]
    same = segment_ids[:, :, None] == segment_ids[:, None, :]
    live = (segment_ids != 0)[:, None, :]
    return causal & same & live


def forward_hidden(params: dict, tokens: torch.Tensor, cfg: LlamaConfig,
                   positions: Optional[torch.Tensor] = None,
                   segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Backbone: tokens [B, S] → hidden states [B, S, D] after ln_f (dense MLPs: no
    MoE aux loss).

    ``segment_ids`` (packed rows, 0 = pad) keep attention inside each segment —
    in-kernel on the flash path, through the block-diagonal mask on the xla path — and
    default the positions to per-segment RoPE restarts. Layer i is banded by
    ``cfg.sliding_window`` iff ``i % window_every == 0``. Under a mesh with a ``tp``
    axis the params are this rank's shards (module docstring)."""
    check_supported(cfg)
    B, S = tokens.shape
    dev = tokens.device
    tp = _tp_group(cfg)
    if positions is None:
        positions = (segment_positions(segment_ids) if segment_ids is not None
                     else torch.arange(S, device=dev).expand(B, S))
    x = _embed(params, tokens.long(), cfg, tp)
    full_mask = (segment_mask(segment_ids) if segment_ids is not None
                 else torch.tril(torch.ones((S, S), dtype=torch.bool, device=dev))[None])
    mask = full_mask
    if cfg.sliding_window:
        idx = torch.arange(S, device=dev)
        mask = full_mask & (idx[None, :] > idx[:, None] - cfg.sliding_window)[None]
    block = _maybe_remat_block(cfg)
    for layer, layer_cfg in zip(params["layers"], _layer_cfgs(cfg)):
        x = block(x, layer, positions, mask if layer_cfg.sliding_window else full_mask,
                  layer_cfg, segment_ids, tp)
    return _rms_norm(x, materialize(params["ln_f"]), cfg.norm_eps, cfg.norm_plus_one)


def _tp_group(cfg: LlamaConfig):
    """The current mesh's tensor-parallel group (``None`` without one), with the
    config's head counts checked against it."""
    mesh = current_mesh()
    tp = mesh.group(TENSOR_AXIS) if mesh is not None else None
    n = group_rank_size(tp)[1]
    if cfg.n_heads % n or cfg.n_kv_heads % n:
        raise ValueError(f"tp={n} must divide n_heads={cfg.n_heads} and "
                         f"n_kv_heads={cfg.n_kv_heads} (whole GQA groups per rank)")
    return tp


def forward(params: dict, tokens: torch.Tensor, cfg: LlamaConfig,
            positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Causal LM: tokens [B, S] → fp32 logits [B, S, V] (this rank's vocab slice under
    a tp mesh)."""
    return head_logits(forward_hidden(params, tokens, cfg, positions), params, cfg)


def _ce_from_hidden(x, params, targets, mask, cfg: LlamaConfig) -> torch.Tensor:
    """Mean next-token CE from post-ln_f hidden states (chunked per ``cfg.loss_chunk``).
    Under a mesh the mean is over every batch rank's tokens: the token count is summed
    over the batch ranks before the division."""
    head = _head(params, cfg)
    count = mask.sum()
    mesh = current_mesh()
    if mesh is not None:
        count = all_reduce(count.detach().clone(), "sum", mesh.group(BATCH_AXES))
    denom = torch.clamp(count, min=1.0)
    total = ce_sum_dispatch(
        x, head, targets, mask, loss_impl=cfg.loss_impl, dtype=cfg.dtype,
        chunk=resolve_loss_chunk(cfg.loss_chunk, x.shape[1], cfg.vocab_size),
        softcap=cfg.final_softcap,
    )
    return total / denom


@gathers_fsdp_shards
def loss_fn(params: dict, batch: dict, cfg: LlamaConfig, rng=None) -> torch.Tensor:
    """Next-token cross-entropy over ``batch`` = {"tokens": [B, S+1]} with optional
    "mask" [B, S+1], packed "segment_ids" [B, S+1] and "positions" [B, S+1]. ZeRO-3
    ``FsdpShard`` leaves are gathered at their use (module docstring)."""
    tokens = batch["tokens"].long()
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    B, S = inputs.shape
    if "segment_ids" in batch:
        seg = batch["segment_ids"]
        mask = packed_target_mask(seg)
        if "mask" in batch:
            mask = mask * batch["mask"][:, 1:].float()
        positions = (batch["positions"][:, :-1] if "positions" in batch
                     else segment_positions(seg[:, :-1]))
        x = forward_hidden(params, inputs, cfg, positions=positions, segment_ids=seg[:, :-1])
    else:
        mask = (batch["mask"][:, 1:].float() if "mask" in batch
                else torch.ones((B, S), dtype=torch.float32, device=tokens.device))
        x = forward_hidden(params, inputs, cfg)
    return _ce_from_hidden(x, params, targets, mask, cfg)


# ----------------------------------------------------------------------- cached generation
def init_cache(cfg: LlamaConfig, batch_size: int, max_len: int, dtype=None,
               quantized: Optional[bool] = None, device=None,
               device_index: bool = False) -> dict:
    """Empty dense KV cache for ``batch_size`` sequences of up to ``max_len`` tokens:
    ``{"layers": [{"k": [B,C,K,hd], "v": ...}, ...], "valid": [B,C] bool, "index": int}``
    — ``valid`` marks filled, non-pad slots, ``index`` is the next write slot.
    ``quantized`` (default ``cfg.kv_quant``): int8 k/v plus fp32 scales.
    ``device_index``: the index is a 0-d int64 tensor on the cache's device instead, so
    that a forward replayed from a CUDA graph reads the write slot there (a Python int
    would be baked into the graph) and the caller advances it in place."""
    quantized = cfg.kv_quant if quantized is None else quantized
    dtype = dtype or cfg.dtype
    dev = resolve_device(device)
    return {
        "layers": [
            _kv_planes(batch_size, max_len, cfg.n_kv_heads, cfg.head_dim, dtype, quantized,
                       dev)
            for _ in range(cfg.n_layers)
        ],
        "valid": torch.zeros((batch_size, max_len), dtype=torch.bool, device=dev),
        "index": torch.zeros((), dtype=torch.long, device=dev) if device_index else 0,
    }


def init_paged_cache(cfg: LlamaConfig, batch_size: int, max_len: int, num_pages: int,
                     page_size: int, dtype=None, quantized: Optional[bool] = None,
                     device=None) -> dict:
    """Empty PAGED KV cache: per-layer pool planes ``[num_pages, page_size, K, hd]``
    plus the per-lane valid mask ``[batch_size, max_len]`` (dense by logical position).
    Which lane owns which page lives in the host-side ``paged_kv.BlockManager``."""
    quantized = cfg.kv_quant if quantized is None else quantized
    dtype = dtype or cfg.dtype
    dev = resolve_device(device)
    return {
        "layers": [
            _paged_kv_planes(num_pages, page_size, cfg.n_kv_heads, cfg.head_dim, dtype,
                             quantized, dev)
            for _ in range(cfg.n_layers)
        ],
        "valid": torch.zeros((batch_size, max_len), dtype=torch.bool, device=dev),
    }


def _attention_cached(q, ck, cv, q_positions, valid, cfg: LlamaConfig):
    """q [B,T,H,hd] against the full cache ck/cv [B,C,K,hd]; ``valid`` [B,C] marks live
    keys; key slot j is visible to the query at absolute slot p iff ``j <= p``. Masked
    scores take ``finfo(dtype).min`` before the fp32 softmax, so a fully masked row is
    uniform (unlike the kernel's zeros) — exactly the JAX dense path."""
    B, T, H, hd = q.shape
    C, K = ck.shape[1], ck.shape[2]
    G = H // K
    qg = q.reshape(B, T, K, G, hd)
    scores = torch.einsum("btkgd,bckd->bkgtc", qg, ck) * _sm_scale(cfg)
    scores = _softcap(scores, cfg.attn_softcap)
    slots = torch.arange(C, device=q.device)[None, None, :]
    causal = slots <= q_positions[:, :, None]  # [B,T,C]
    if cfg.sliding_window:
        causal = causal & (slots > q_positions[:, :, None] - cfg.sliding_window)
    mask = (causal & valid[:, None, :])[:, None, None, :, :]  # [B,1,1,T,C]
    scores = torch.where(mask, scores, torch.finfo(scores.dtype).min)
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    return torch.einsum("bkgtc,bckd->btkgd", probs, cv).reshape(B, T, H, hd)


def _block_cached(x, layer, kv, index, positions, valid, cfg: LlamaConfig, paged=None):
    """One block with KV-cache read/write → (x, new_kv); the cache planes are updated
    in place.

    ``index`` is the write slot: an int advances every row together (prefill), a
    tensor ``[B]`` gives each row its own slot (the continuous-batching engine).
    ``paged`` — ``(tables, pages, offs, start_positions, page_size)`` switches the KV
    side to the paged pool: writes go through the precomputed physical (page, slot)
    grid, reads through ``common.paged_attention_dispatch`` (the CUDA kernel on the
    card, gather into this module's ``_attention_cached`` on the CPU)."""
    B, T, D = x.shape
    p1 = cfg.norm_plus_one
    h = _rms_norm(x, layer["ln_attn"], cfg.norm_eps, p1)
    q, k, v = _qkv_proj(h, layer, cfg)
    q = q.reshape(B, T, cfg.n_heads, cfg.head_dim)
    k = k.reshape(B, T, cfg.n_kv_heads, cfg.head_dim)
    v = v.reshape(B, T, cfg.n_kv_heads, cfg.head_dim)
    q = _rope(q, positions, cfg)
    k = _rope(k, positions, cfg)
    if paged is not None:
        tables, pages, offs, start_pos, page_size = paged
        new_kv = {**_write_cache_paged(kv, "k", k, pages, offs),
                  **_write_cache_paged(kv, "v", v, pages, offs)}
        attn = _paged_attention(
            q, new_kv, tables, start_pos, valid, page_size=page_size,
            sm_scale=_sm_scale(cfg), window=cfg.sliding_window,
            softcap=cfg.attn_softcap, dtype=cfg.dtype,
            dense_attention=lambda ck, cv: _attention_cached(
                q, ck, cv, positions, valid, cfg
            ),
        )
    else:
        new_kv = {**_write_cache(kv, "k", k, index), **_write_cache(kv, "v", v, index)}
        attn = _attention_cached(
            q, _read_cache(new_kv, "k", cfg.dtype), _read_cache(new_kv, "v", cfg.dtype),
            positions, valid, cfg,
        )
    attn_out = _proj_l(attn.reshape(B, T, cfg.n_heads * cfg.head_dim), layer, "wo", cfg)
    if cfg.post_norm:
        attn_out = _rms_norm(attn_out, layer["ln_attn_post"], cfg.norm_eps, p1)
    x = x + attn_out
    h = _rms_norm(x, layer["ln_mlp"], cfg.norm_eps, p1)
    gate = _mlp_gate_act(_proj_l(h, layer, "w_gate", cfg), cfg)
    up = _proj_l(h, layer, "w_up", cfg)
    mlp_out = _proj_l(gate * up, layer, "w_down", cfg)
    if cfg.post_norm:
        mlp_out = _rms_norm(mlp_out, layer["ln_mlp_post"], cfg.norm_eps, p1)
    return x + mlp_out, new_kv


def _cache_advance(cache: dict, tokens: torch.Tensor, token_mask: Optional[torch.Tensor]):
    """(write index, absolute rope positions [B,T], valid mask [B,C]); the valid mask
    is updated in place at the index, whose start clamps into range like
    ``dynamic_update_slice``. The index is an int, or a 0-d device tensor that never
    leaves the device (``generate``'s decode steps, replayed from a CUDA graph)."""
    B, T = tokens.shape
    index = cache["index"]
    positions = index + torch.arange(T, dtype=torch.int32, device=tokens.device)
    positions = positions[None, :].expand(B, T)
    if token_mask is None:
        token_mask = torch.ones((B, T), dtype=torch.bool, device=tokens.device)
    valid = cache["valid"]
    C = valid.shape[1]
    if torch.is_tensor(index):
        slots = index.long().clamp(0, C - T) + torch.arange(T, device=valid.device)
        valid.index_copy_(1, slots, token_mask)
    else:
        start = min(max(index, 0), C - T)
        valid[:, start:start + T] = token_mask
    return index, positions, valid


def _embed(params: dict, tokens: torch.Tensor, cfg: LlamaConfig, tp=None) -> torch.Tensor:
    """Token embeddings in ``cfg.dtype``; ``tp``: the group over whose ranks the table's
    rows are sharded (the vocab-parallel lookup)."""
    table = _dense_leaf(materialize(params["embed"]), "embed")
    if tp is not None:
        x = vocab_parallel_embedding(table, tokens, tp, dtype=cfg.dtype)
    else:
        # F.embedding, not ``table[tokens]``: its backward sums repeated tokens' rows in a
        # fixed order (the indexing backward accumulates them in a thread-dependent order
        # on the CPU), so a resumed run repeats the unbroken run's bits.
        x = F.embedding(tokens, table).to(cfg.dtype)
    if cfg.embed_scale:
        # A 0-d CPU tensor rides into the kernel as a scalar: no host-to-device copy.
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=cfg.dtype)
    return x


def _layer_cfgs(cfg: LlamaConfig):
    """Per-layer configs: layer i is banded iff ``cfg.sliding_window`` and
    ``i % window_every == 0`` (the unstacked branch of the JAX forwards)."""
    full_cfg = dataclasses.replace(cfg, sliding_window=0)
    return [cfg if cfg.sliding_window and i % cfg.window_every == 0 else full_cfg
            for i in range(cfg.n_layers)]


def forward_cached(params: dict, tokens: torch.Tensor, cache: dict, cfg: LlamaConfig,
                   token_mask: Optional[torch.Tensor] = None,
                   last_only: bool = False) -> tuple[torch.Tensor, dict]:
    """Write ``tokens`` [B,T] into the cache at its current index (in place) and return
    (fp32 logits, cache) — logits [B,T,V], or [B,1,V] with ``last_only``. Prefill
    passes the left-padded prompt with ``token_mask`` False on pads. ``cache["index"]``
    may be a 0-d device tensor (``init_cache(device_index=True)``); the returned cache
    then holds ``index + T`` as one, and nothing in the call waits on the host, so it
    can be captured into a CUDA graph (``generate``'s decode step, the serving
    engine's prefill programs)."""
    T = tokens.shape[1]
    index, positions, valid = _cache_advance(cache, tokens, token_mask)
    x = _embed(params, tokens, cfg)
    new_layers = []
    for layer, kv, layer_cfg in zip(params["layers"], cache["layers"], _layer_cfgs(cfg)):
        x, new_kv = _block_cached(x, layer, kv, index, positions, valid, layer_cfg)
        new_layers.append(new_kv)
    x = _rms_norm(x, params["ln_f"], cfg.norm_eps, cfg.norm_plus_one)
    if last_only:
        x = x[:, -1:, :]
    logits = head_logits(x, params, cfg)
    return logits, {"layers": new_layers, "valid": valid, "index": index + T}


def forward_slots(params: dict, tokens: torch.Tensor, cache: dict, positions: torch.Tensor,
                  cfg: LlamaConfig, tables: Optional[torch.Tensor] = None,
                  page_size: int = 0) -> tuple[torch.Tensor, dict]:
    """Per-slot cached forward: ``tokens`` [B,T] written (in place) at each row's own
    cache slots ``positions[b] .. positions[b]+T-1`` → (fp32 logits [B,T,V], cache).

    ``tables``/``page_size`` switch the KV side to the PAGED layout (``cache`` from
    :func:`init_paged_cache`): writes scatter through each lane's block-table row
    (sentinel and past-``max_len`` positions drop), reads go through the paged
    dispatch. One implementation serves both layouts."""
    B, T = tokens.shape
    C = cache["valid"].shape[1]
    pos_grid = positions[:, None] + torch.arange(T, dtype=positions.dtype,
                                                 device=positions.device)[None, :]
    valid = cache["valid"]
    keep = (pos_grid < C).reshape(-1)  # JAX's scatter drops out-of-range slots
    put_or_drop(valid, torch.arange(B, device=valid.device).repeat_interleave(T),
                pos_grid.reshape(-1).long(), keep, keep)
    paged = None
    if tables is not None:
        num_pages = cache["layers"][0]["k"].shape[0]
        pages, offs = _paged_write_coords(tables, pos_grid, page_size, C, num_pages)
        paged = (tables, pages, offs, positions, page_size)
    x = _embed(params, tokens, cfg)
    new_layers = []
    for layer, kv, layer_cfg in zip(params["layers"], cache["layers"], _layer_cfgs(cfg)):
        x, new_kv = _block_cached(x, layer, kv, positions, pos_grid, valid, layer_cfg,
                                  paged=paged)
        new_layers.append(new_kv)
    x = _rms_norm(x, params["ln_f"], cfg.norm_eps, cfg.norm_plus_one)
    logits = head_logits(x, params, cfg)
    if paged is not None:
        return logits, {"layers": new_layers, "valid": valid}
    return logits, {"layers": new_layers, "valid": valid, "index": cache["index"]}


def forward_slots_paged(params: dict, tokens: torch.Tensor, cache: dict,
                        tables: torch.Tensor, positions: torch.Tensor, cfg: LlamaConfig,
                        page_size: int) -> tuple[torch.Tensor, dict]:
    """:func:`forward_slots` over the PAGED cache — the serving engine's entry point
    for the paged layout. ``tables`` [B, MP] int32 maps each lane's logical pages to
    physical pool pages (SENTINEL == num_pages marks unallocated entries; writes
    through them, and at/past max_len, drop). The pool is updated in place."""
    return forward_slots(params, tokens, cache, positions, cfg, tables=tables,
                         page_size=page_size)


def forward_slots_multi(params: dict, cache: dict, tokens: torch.Tensor,
                        positions: torch.Tensor, active: torch.Tensor, budgets: torch.Tensor,
                        eos_ids: torch.Tensor, select_token, xs, n_steps: int,
                        cfg: LlamaConfig, tables: Optional[torch.Tensor] = None,
                        page_size: int = 0):
    """N :func:`forward_slots` decode steps (T == 1) — the super-step the serving
    engine's ``decode_steps=N`` path runs (replayed from a CUDA graph on the card).
    Each step is literally a T == 1 ``forward_slots`` call (same rope positions, same
    valid/causal masking, same paged routing), so per-step logits are the one-token
    engine's; see :func:`~.common.multi_step_decode` for the freeze/emission contract.
    Returns ``(cache, tok_buf [n_steps, B], counts [B], last step's logits [B, V])``."""
    max_len = cache["valid"].shape[1]

    def forward_one(c, tok, write_pos):
        logits, c = forward_slots(params, tok[:, None], c, write_pos, cfg, tables=tables,
                                  page_size=page_size)
        return logits[:, -1, :], c

    return multi_step_decode(forward_one, cache, tokens, positions, active, budgets,
                             eos_ids, select_token, xs, n_steps, max_len)


def forward_slots_spec_multi(params: dict, cache: dict, tokens: torch.Tensor,
                             positions: torch.Tensor, active: torch.Tensor,
                             budgets: torch.Tensor, eos_ids: torch.Tensor, propose,
                             select_ref, noise_tab, history: torch.Tensor,
                             hist_lens: torch.Tensor, n_steps: int, spec_k: int,
                             cfg: LlamaConfig, tables: Optional[torch.Tensor] = None,
                             page_size: int = 0):
    """N speculative draft → verify → accept rounds — the fused super-step the serving
    engine's ``spec_k > 0, decode_steps=N`` path runs (replayed from a CUDA graph on the
    card). Each round's verify is literally a T == spec_k+1 :func:`forward_slots` call,
    dense or paged (the host loop's verify: same rope positions, masking and paged
    routing, so per-round logits are the host loop's); see
    :func:`~.common.spec_multi_step_decode` for the accept, noise-cursor and freeze
    contract. Returns ``(cache, tok_buf [n_steps, B, spec_k+1], emits [n_steps, B],
    counts [B], proposed [B], accepted [B], last round's logits [B, spec_k+1, V])``."""
    max_len = cache["valid"].shape[1]

    def forward_verify(c, seq, write_pos):
        return forward_slots(params, seq, c, write_pos, cfg, tables=tables,
                             page_size=page_size)

    return spec_multi_step_decode(forward_verify, propose, select_ref, cache, tokens,
                                  positions, active, budgets, eos_ids, noise_tab, history,
                                  hist_lens, n_steps, spec_k, max_len)


# ------------------------------------------------------------------- one-request API
def score(params: dict, tokens: torch.Tensor, cfg: LlamaConfig,
          mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-token log-probabilities log p(token[t+1] | tokens[:t+1]) → [B, S-1] fp32.

    The evaluation companion to :func:`loss_fn` (which returns their masked mean
    negated). ``mask`` [B, S] marks real tokens (False on pads); masked target
    positions score 0.0."""
    tokens = torch.as_tensor(tokens).long()
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    logp = torch.log_softmax(forward(params, inputs, cfg), dim=-1)  # final_softcap applied
    ll = torch.gather(logp, -1, targets[..., None]).squeeze(-1)
    if mask is not None:
        ll = ll * torch.as_tensor(mask, device=ll.device)[:, 1:].to(ll.dtype)
    return ll


def perplexity(params: dict, tokens: torch.Tensor, cfg: LlamaConfig,
               mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """exp(mean negative log-likelihood over real target positions) — 0-d fp32."""
    ll = score(params, tokens, cfg, mask)
    if mask is not None:
        denom = torch.clamp(torch.as_tensor(mask, device=ll.device)[:, 1:].sum(), min=1)
    else:
        denom = ll.numel()
    return torch.exp(-ll.sum() / denom)


def _make_gen_fns(cfg: LlamaConfig, max_len: int):
    """(prefill, decode) pair for ``generation.generate_loop``. The prefill writes into
    one cache per (batch, device), kept by the pair (``prefill_fn.caches``) and reset per
    call (``valid`` cleared, index 0), so that a decode graph captured on it serves later
    calls; the cache's write index is a 0-d tensor on the device, so that the decode step
    reads and advances it there (a step replayed from a CUDA graph reads no host value)."""
    caches: dict = {}

    def prefill_fn(params, prompt, prompt_mask):
        key = (prompt.shape[0], prompt.device)
        cache = caches.get(key)
        if cache is None:
            cache = init_cache(cfg, prompt.shape[0], max_len, device=prompt.device,
                               device_index=True)
            caches[key] = cache
        else:
            cache["valid"].zero_()
            cache["index"].zero_()
        logits, new = forward_cached(params, prompt, cache, cfg, token_mask=prompt_mask,
                                     last_only=True)
        cache["index"].copy_(new["index"])
        return logits[:, -1, :], cache

    def decode_fn(params, cache, token):
        logits, cache = forward_cached(params, token[:, None], cache, cfg)
        return logits[:, -1, :], cache

    prefill_fn.caches = caches
    return prefill_fn, decode_fn


def _pair_held(pair) -> tuple[list, int]:
    return [t for cache in pair[0].caches.values() for t in tree_leaves(cache)
            if torch.is_tensor(t)], 0


def generate_fns(cfg: LlamaConfig, max_len: int):
    """The (prefill, decode) pair ``generate`` uses for ``cfg`` and a bucketed
    ``max_len`` (a multiple of 64), from ``generation``'s byte-bounded cache: stable
    identities keep its decode graphs warm, as JAX's cache keeps compiled programs."""
    from ..generation import cache_lookup, cache_store

    key = ("fns", cfg, max_len)
    pair = cache_lookup(key)
    return pair if pair is not None else cache_store(key, _make_gen_fns(cfg, max_len),
                                                     _pair_held)


def generate(params: dict, prompt, cfg: LlamaConfig, gen=None, seed: Optional[int] = None,
             prompt_mask=None) -> torch.Tensor:
    """Autoregressive generation: prefill, then ``max_new_tokens - 1`` cached decode
    steps (``generation.generate_loop``; on the card the decode steps replay one CUDA
    graph, with one host read at the end).

    ``prompt`` [B,S0] int (left-padded; pass ``prompt_mask`` False on pads), moved to
    the params' device. Returns int32 [B, max_new_tokens] on that device. Sampled
    generation draws emission t of every row from ``seed`` (default 0), where JAX takes
    a key. The caches and graphs it keeps are released by
    ``generation.release_generate_caches``."""
    from ..generation import GenerationConfig, generate_loop

    gen = gen or GenerationConfig()
    dev = _dense_leaf(params["embed"], "embed").device
    prompt = torch.as_tensor(prompt, device=dev).to(torch.int32)
    if prompt_mask is None:
        prompt_mask = torch.ones(prompt.shape, dtype=torch.bool, device=dev)
    prompt_mask = torch.as_tensor(prompt_mask, device=dev).bool()
    max_len = -(-(prompt.shape[1] + gen.max_new_tokens) // 64) * 64
    prefill_fn, decode_fn = generate_fns(cfg, max_len)
    return generate_loop(prefill_fn, decode_fn, params, prompt, prompt_mask, gen, seed)
