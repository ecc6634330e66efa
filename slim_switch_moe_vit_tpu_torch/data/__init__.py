"""Data pipeline: datasets, samplers, the loader, host geometry (the native
crop library), and the on-device augmentation and mixup."""
from .datasets import build_dataset, build_split_dataset  # noqa: F401
from .device_aug import (  # noqa: F401
    IMAGENET_DEFAULT_MEAN,
    IMAGENET_DEFAULT_STD,
    build_device_augment,
    build_eval_normalize,
)
from .loader import DataLoader  # noqa: F401
from .mixup import make_mixup_fn, mixup_active  # noqa: F401
from .samplers import (  # noqa: F401
    DistributedSampler,
    RASampler,
    SequentialSampler,
)
