"""Model definitions; importing this package registers every model."""
from . import zoo  # noqa: F401  (registers the deit_* and vit_* models)
from . import resmoe  # noqa: F401  (registers the moe_* models)
from .registry import create_model, list_models, register_model  # noqa: F401
