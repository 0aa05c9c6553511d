"""Static and runtime analysis of the port's round path (port of
``repro.analysis``):

* :mod:`repro_torch.analysis.lint` — the repo lint: standard-library AST
  rules for the round path's contracts (``python -m
  repro_torch.analysis.lint src/repro_torch``).
* :mod:`repro_torch.analysis.op_checks` — the same contracts read from
  the ops a round runs (a ``TorchDispatchMode``): no wait for the card
  outside ``host_readback``, no float64 outside the ledger's row, the
  in-place cache writes kept in place.  It takes the place of the
  reference's HLO checks.
* :mod:`repro_torch.analysis.audit` — the invariant auditor: two rounds
  of an engine under ``op_checks`` and the transfer ceiling
  (``python -m repro_torch.analysis.audit``).
* :mod:`repro_torch.analysis.runtime` — the ``FLConfig.debug_checks``
  sanitisers (round guard, rebuild detector).

The submodules are not imported here: ``lint`` is a standard-library CLI
(importing it from the package would trip runpy's double-import warning
under ``python -m``), and the others import the engine.
"""
