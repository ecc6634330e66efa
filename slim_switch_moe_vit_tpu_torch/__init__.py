"""PyTorch + CUDA port of the Slim-Switch-MoE-ViT serving and training paths
for Hopper.

Imports ``torch`` only; the JAX package ``slim_switch_moe_vit_tpu`` is the
reference this package is tested against and is never imported here.
"""
from .models import create_model, list_models  # noqa: F401

__version__ = "0.1.0"
