"""Optimizer, learning-rate schedules and gradient compression (port of
``repro.optim``)."""
