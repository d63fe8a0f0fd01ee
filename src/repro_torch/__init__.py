"""PyTorch/CUDA port of the LUTMUL serving stack (``src/repro`` is the JAX
reference it is held against).

Layout mirrors ``repro``: ``core`` (product tables, int4 packing, device
choice), ``kernels`` (the hand-written CUDA kernels under ``csrc/``, their
ctypes build and the dispatch in ``kernels.lutmul.ops``), ``models`` (the
decoder families, whisper and MobileNetV2, with their losses), ``serve``
(quantize-at-load, engine, scheduler), ``dist`` (meshes, tensor
parallelism, straggler detection), ``train`` (the train step and the
fault-tolerant loop), ``optim`` (AdamW, schedules, gradient compression),
``data`` (the synthetic pipeline), ``configs`` and ``convert`` (JAX
parameter trees -> port parameters).

Weights keep the reference layout at every public function: a projection is
``x @ W`` with ``W`` of shape ``[K, N]``, nibble-packed codes are
``[K//2, N]``.  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; with no GPU and no explicit device they raise.
"""
