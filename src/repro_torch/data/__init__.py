"""Synthetic, shard-aware training data (port of ``repro.data``)."""
