"""PyTorch/CUDA port of the LUTMUL serving stack (``src/repro`` is the JAX
reference it is held against).

Layout mirrors ``repro``: ``core`` (product tables, int4 packing, device
choice), ``kernels`` (the hand-written CUDA kernels under ``csrc/``, their
ctypes build and the dispatch in ``kernels.lutmul.ops``), ``models`` (the
dense decoder), ``serve`` (quantize-at-load, engine, scheduler), ``configs``
and ``convert`` (JAX parameter trees -> port parameters).

Weights keep the reference layout at every public function: a projection is
``x @ W`` with ``W`` of shape ``[K, N]``, nibble-packed codes are
``[K//2, N]``.  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; with no GPU and no explicit device they raise.
"""
