"""Shape buckets for serving prefill (a part of ``accelerate_tpu/compile_cache/``).

The port keeps its own copy of :func:`~.buckets.pick_bucket`, which
``serving.ContinuousBatcher(prompt_buckets=...)`` uses to pad each prompt to the
smallest rung of its ladder: on the card one CUDA graph per rung is captured (and
replayed) where the JAX engine compiles one program per rung.

Not ported: the persistent AOT executable cache (``AotCache``, ``CachedFunction``,
the fingerprints), the warm-up CLI and manifest, and ``CompileCacheConfig`` with its
geometric ``ladder()`` — the port's engine takes ``prompt_buckets`` explicitly, and
``ContinuousBatcher.warm_programs()`` captures its graphs in the process.
"""

from .buckets import pick_bucket

__all__ = ["pick_bucket"]
