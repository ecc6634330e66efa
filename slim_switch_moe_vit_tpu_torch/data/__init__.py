"""On-device data transforms for serving."""
from .device_aug import (  # noqa: F401
    IMAGENET_DEFAULT_MEAN,
    IMAGENET_DEFAULT_STD,
    build_eval_normalize,
)
