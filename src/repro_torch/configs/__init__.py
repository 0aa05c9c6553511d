"""Configuration dataclasses of the port."""
from repro_torch.configs.base import FLConfig  # noqa: F401
