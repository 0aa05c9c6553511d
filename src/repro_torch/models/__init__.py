"""Models of the port: the FL classifier's substrate and the causal LMs
(``build_model``): the dense GQA decoder, the zamba2 hybrid and RWKV6."""
from repro_torch.models.model import Model, build_model  # noqa: F401
from repro_torch.models.transformer import ExecConfig  # noqa: F401
