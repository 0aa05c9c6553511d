"""Tree checkpoints (the port of ``repro.checkpoint``)."""
