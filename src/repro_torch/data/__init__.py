"""Synthetic federated datasets (numpy copies of ``repro.data``)."""
