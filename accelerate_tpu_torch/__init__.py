"""PyTorch + CUDA port of ``accelerate_tpu`` for NVIDIA Hopper (H100).

The JAX package beside this one is the reference: every module here mirrors its
counterpart's layout, names and tensor layouts, so a reader can find each piece in
both. This package imports ``torch`` and ``numpy`` only — never ``jax`` and nothing
of ``accelerate_tpu``.

Entry points run on CUDA unless the caller passes ``device="cpu"`` (the CPU tests
do); hand-written kernels live under ``csrc/`` and are built at first use
(``ops/_build.py``). On CPU tensors each kernel wrapper runs its plain PyTorch
version instead.

Ported so far (slice 1): the paged continuous-batching serving path —
``serving.ContinuousBatcher`` over ``models.llama`` with the paged-attention decode
kernel (``ops/paged_attention.py``, ``csrc/paged_attention.cu``).
"""

__version__ = "0.1.0"
