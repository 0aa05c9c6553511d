"""Functional optimizers (the port of ``repro.optim``)."""
