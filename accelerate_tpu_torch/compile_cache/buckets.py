"""Shape-bucket helpers for serving prefill.

A copy of ``accelerate_tpu/compile_cache/buckets.py`` (pure Python). A prompt padded
to the smallest bucket of a ladder runs one prefill program per *bucket* instead of
one per *length*: on the card one CUDA graph per bucket, enumerable ahead of time
(``ContinuousBatcher.warm_programs``).
"""

from __future__ import annotations

from typing import Optional, Sequence

__all__ = ["pick_bucket"]


def pick_bucket(length: int, ladder: Sequence[int]) -> Optional[int]:
    """Smallest ladder bucket that fits ``length`` tokens, or None when the
    prompt exceeds the largest bucket (caller falls back to chunked prefill)."""
    for bucket in ladder:
        if length <= bucket:
            return bucket
    return None
