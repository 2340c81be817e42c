"""PyTorch + CUDA port of ``accelerate_tpu`` for NVIDIA Hopper (H100).

The JAX package beside this one is the reference: every module here mirrors its
counterpart's layout, names and tensor layouts, so a reader can find each piece in
both. This package imports ``torch`` and ``numpy`` only — never ``jax`` and nothing
of ``accelerate_tpu``.

Entry points run on CUDA unless the caller passes ``device="cpu"`` (the CPU tests
do); hand-written kernels live under ``csrc/`` and are built at first use
(``ops/_build.py``). On CPU tensors each kernel wrapper runs its plain PyTorch
version instead.

Ported so far:

- slice 1, serving: the paged continuous-batching engine — ``serving.ContinuousBatcher``
  over ``models.llama`` with the paged-attention decode kernel
  (``ops/paged_attention.py``, ``csrc/paged_attention.cu``);
- slice 2, training: ``accelerator.Accelerator`` (``create_train_state``,
  ``build_train_step``, ``build_eval_step``) over ``models.llama.loss_fn``, with the
  flash-attention forward/backward kernels (``ops/flash_attention.py``,
  ``csrc/flash_attention.cu``), the fused AdamW kernel (``ops/fused_optim.py``,
  ``csrc/fused_adamw.cu``), ``optim`` (the optax counterparts), ``state`` and
  ``optimizer``;
- slice 3, the fused linear + cross-entropy (``ops/fused_xent.py``,
  ``csrc/fused_xent.cu``) behind ``loss_impl="fused"``;
- slice 4, int8 weight-only serving: ``ops/quantization.py`` (int8/int4/nf4 leaves)
  and the quantized projection branch of ``models.llama``, with the int8 matmul
  kernel (``csrc/int8_matmul.cu``);
- slice 5, tensor-parallel training: ``launchers`` (one process per rank), the process
  mesh (``parallel/mesh.py``) and Megatron placement with its collectives
  (``parallel/tp.py``), multi-process ``state``, ``llama.partition_specs`` and the
  sharded forward, and ``loss_impl="fused_tp"`` with the vocab-sharded partial forward
  kernel (``csrc/fused_xent.cu``, ``ops/fused_xent.fused_cross_entropy_tp``);
- slice 10, device-resident decode: ``ContinuousBatcher(decode_steps=N)`` super-steps
  replayed from CUDA graphs (``utils/cuda_graph.py``) and ``llama.generate``/``score``/
  ``perplexity`` (``generation.py``);
- slice 11, training I/O: ``data_loader`` (samplers, sharded and dispatched loaders),
  ``lm_dataset`` over ``native/lmdata.cpp``, ``checkpointing`` (verified save/resume),
  ``scheduler``, ``logging``, ``utils/operations`` and ``utils/random``, and the
  ``Accelerator`` surface over them.
"""

__version__ = "0.1.0"
