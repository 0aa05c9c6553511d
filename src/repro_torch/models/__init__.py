"""Models of the port: the FL classifier's substrate and the dense GQA
decoder (``build_model``)."""
from repro_torch.models.model import Model, build_model  # noqa: F401
from repro_torch.models.transformer import ExecConfig  # noqa: F401
