"""Model definitions; importing this package registers every model."""
from . import zoo  # noqa: F401  (registers the deit_* and vit_* models)
from . import resmoe  # noqa: F401  (registers the moe_* models)
from . import regnet  # noqa: F401  (registers the regnety_* teachers)
from . import sparse  # noqa: F401  (registers sparse_deit_tiny_*)
from . import switchable  # noqa: F401  (registers deit_sw_tiny_*)
from .registry import create_model, list_models, register_model  # noqa: F401
