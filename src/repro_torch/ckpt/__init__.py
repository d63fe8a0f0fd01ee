"""Checkpointing (port of ``repro.ckpt``): atomic, optionally asynchronous
msgpack + zstd (or zlib) checkpoints of a tree of tensors."""
