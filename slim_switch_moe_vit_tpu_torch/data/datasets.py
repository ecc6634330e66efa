"""Dataset builders, framework-free.

Port of ``slim_switch_moe_vit_tpu/data/datasets.py`` (a copy: the module
imports numpy only): ``build_dataset(is_train, args)`` ->
``(dataset, nb_classes)`` and ``build_split_dataset`` for the
continual-learning class ranges. CIFAR reads the python pickle batches,
folder datasets decode with PIL (imported only when such a dataset is read),
iNat parses the official JSON, and ``SYNTH`` makes deterministic random
uint8 images for runs without mounted data.

Datasets return uint8 HWC arrays; the host geometry is ``transforms.py``
(per sample), the photometric part ``device_aug.py`` (batched, on the
device).
"""
from __future__ import annotations

import json
import os
import pickle
import typing as typ

import numpy as np

IMAGENET_DEFAULT_MEAN = (0.485, 0.456, 0.406)
IMAGENET_DEFAULT_STD = (0.229, 0.224, 0.225)

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".pgm", ".tif",
                  ".tiff", ".webp")


def _apply_transform(transform, img, idx):
    """Apply a transform, passing the sample index to transforms that derive
    per-sample RNG from it (``wants_index``, see transforms.TrainTransform)."""
    if transform is None:
        return img
    if getattr(transform, "wants_index", False):
        return transform(img, idx)
    return transform(img)


class ArrayDataset:
    """In-memory uint8 images + int labels."""

    def __init__(self, images: np.ndarray, labels: np.ndarray, transform=None):
        assert len(images) == len(labels)
        self.images = images
        self.targets = np.asarray(labels, dtype=np.int64)
        self.transform = transform

    def __len__(self):
        return len(self.images)

    def __getitem__(self, idx):
        img = _apply_transform(self.transform, self.images[idx], idx)
        return img, int(self.targets[idx])


class SynthDataset:
    """Deterministic random dataset for smoke tests / benches (no real data
    mounted). Image i is a fixed pseudo-random uint8 tensor.

    ``learnable=True`` makes the label a visual function of the image (which
    horizontal band carries a bright stripe — flip-invariant, so the standard
    hflip augmentation doesn't corrupt labels), so a short training run must
    beat chance — an end-to-end learning sanity check."""

    def __init__(self, n: int, img_size: int, nb_classes: int, transform=None,
                 seed: int = 0, learnable: bool = False):
        self.n = n
        self.img_size = img_size
        self.nb_classes = nb_classes
        self.transform = transform
        self.learnable = learnable
        rng = np.random.RandomState(seed)
        self.targets = rng.randint(0, nb_classes, size=n).astype(np.int64)

    def __len__(self):
        return self.n

    def __getitem__(self, idx):
        rng = np.random.RandomState(idx + 12345)
        img = rng.randint(0, 256, (self.img_size, self.img_size, 3), np.uint8)
        if self.learnable:
            cls = int(self.targets[idx]) % 4
            s = self.img_size // 4
            y0 = cls * s
            # bright stripe in the class band (hflip-invariant)
            img[y0:y0 + s] = np.minimum(
                img[y0:y0 + s].astype(np.int32) + 120, 255
            ).astype(np.uint8)
            self.targets[idx] = cls
        img = _apply_transform(self.transform, img, idx)
        return img, int(self.targets[idx])


class FolderDataset:
    """ImageFolder: root/<class>/<img> (reference: torchvision ImageFolder at
    datasets.py:254-263). Decodes lazily with PIL."""

    def __init__(self, root: str, transform=None,
                 class_filter: typ.Optional[typ.Callable] = None,
                 class_index: typ.Optional[typ.Dict[str, int]] = None):
        if class_index is None:
            classes = sorted(
                d.name for d in os.scandir(root) if d.is_dir()
            )
            if class_filter is not None:
                classes = class_filter(classes)
            class_index = {c: i for i, c in enumerate(classes)}
        self.class_to_idx = dict(class_index)
        self.samples: typ.List[typ.Tuple[str, int]] = []
        for c in sorted(self.class_to_idx):
            cdir = os.path.join(root, c)
            for fn in sorted(os.listdir(cdir)):
                if fn.lower().endswith(IMG_EXTENSIONS):
                    self.samples.append((os.path.join(cdir, fn),
                                         self.class_to_idx[c]))
        self.targets = np.asarray([t for _, t in self.samples], dtype=np.int64)
        self.transform = transform

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx):
        from PIL import Image

        path, target = self.samples[idx]
        img = Image.open(path).convert("RGB")
        img = np.asarray(img, dtype=np.uint8)
        img = _apply_transform(self.transform, img, idx)
        return img, target


class INatDataset(FolderDataset):
    """iNaturalist 2018/2019 from the official JSON annotation files
    (behavioral parity: reference datasets.py:159-207).

    Labels are dense ids for the chosen taxonomic attribute (``category`` ∈
    name/kingdom/genus/...), assigned by first appearance while scanning the
    *train*-split annotations — so train and val share one label space, and
    coarser attributes collapse many species onto one id.
    """

    def __init__(self, root, train=True, year=2018, transform=None,
                 category="name"):
        split = "train" if train else "val"
        split_meta = self._read_json(root, f"{split}{year}.json")
        taxonomy = self._read_json(root, "categories.json")
        train_anns = self._read_json(root, f"train{year}.json")["annotations"]

        label_of: typ.Dict[str, int] = {}
        for ann in train_anns:
            attr = taxonomy[int(ann["category_id"])][category]
            label_of.setdefault(attr, len(label_of))
        self.nb_classes = len(label_of)

        self.samples = []
        for rec in split_meta["images"]:
            # file_name is "<split_dir>/<supercategory>/<cat_id>/<file>"; the
            # on-disk layout has no supercategory level, so component [1] is
            # dropped when rebuilding the path (reference does the same).
            parts = rec["file_name"].split("/")
            species = int(parts[2])
            img_path = os.path.join(root, parts[0], parts[2], parts[3])
            self.samples.append((img_path, label_of[taxonomy[species][category]]))
        self.targets = np.asarray([lbl for _, lbl in self.samples],
                                  dtype=np.int64)
        self.transform = transform

    @staticmethod
    def _read_json(root, name):
        with open(os.path.join(root, name)) as f:
            return json.load(f)


class Subset:
    """torch.utils.data.Subset equivalent (used at datasets.py:151)."""

    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = np.asarray(indices, dtype=np.int64)
        self.targets = np.asarray(dataset.targets)[self.indices]

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, idx):
        return self.dataset[int(self.indices[idx])]


def _load_cifar(path: str, train: bool, cifar100: bool):
    """Read the standard CIFAR python pickle batches from disk."""
    if cifar100:
        base = os.path.join(path, "cifar-100-python")
        files = ["train"] if train else ["test"]
        label_key = b"fine_labels"
    else:
        base = os.path.join(path, "cifar-10-batches-py")
        files = [f"data_batch_{i}" for i in range(1, 6)] if train else ["test_batch"]
        label_key = b"labels"
    xs, ys = [], []
    for fn in files:
        with open(os.path.join(base, fn), "rb") as f:
            d = pickle.load(f, encoding="bytes")
        xs.append(d[b"data"])
        ys.extend(d[label_key])
    x = np.concatenate(xs).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    return np.ascontiguousarray(x), np.asarray(ys, dtype=np.int64)


def _imagenet100_index(root: str) -> typ.Dict[str, int]:
    """Class→label map for the 100-class ImageNet subset (behavioral parity:
    reference datasets.py:210-236). A pickled map in ``./imnet100/`` (a
    cwd-relative cache the reference environment ships) takes precedence so
    the same 100 classes are used across runs; otherwise take the first 100
    directories in OS scandir order, then sort for label assignment."""
    if os.path.exists("imnet100"):
        with open(os.path.join("imnet100", "train_class_to_idx.pkl"), "rb") as f:
            return pickle.load(f)
    chosen = [d.name for d in os.scandir(root) if d.is_dir()][:100]
    chosen.sort()
    return {c: i for i, c in enumerate(chosen)}


def build_dataset(is_train: bool, args):
    """reference datasets.py:239-287 (+SYNTH)."""
    from .transforms import build_transform

    transform = build_transform(is_train, args)

    if args.data_set == "SYNTH":
        n = getattr(args, "synth_size", 512)
        nb_classes = getattr(args, "synth_classes", 10)
        learnable = getattr(args, "synth_learnable", False)
        if learnable:
            nb_classes = 4
        return SynthDataset(n, args.input_size, nb_classes,
                            transform=transform,
                            learnable=learnable), nb_classes
    if args.data_set == "CIFAR100":
        x, y = _load_cifar(args.data_path, is_train, cifar100=True)
        return ArrayDataset(x, y, transform=transform), 100
    if args.data_set == "CIFAR10":
        x, y = _load_cifar(args.data_path, is_train, cifar100=False)
        return ArrayDataset(x, y, transform=transform), 10
    if args.data_set == "CAR":
        root = os.path.join(args.data_path, "train" if is_train else "val")
        return FolderDataset(root, transform=transform), 196
    if args.data_set == "FLOWER":
        root = os.path.join(args.data_path, "train" if is_train else "val")
        return FolderDataset(root, transform=transform), 102
    if args.data_set == "IMNET":
        root = os.path.join(args.data_path, "train" if is_train else "val")
        return FolderDataset(root, transform=transform), 1000
    if args.data_set == "IMNET100":
        root = os.path.join(args.data_path, "train" if is_train else "val")
        ds = FolderDataset(root, transform=transform,
                           class_index=_imagenet100_index(root))
        return ds, 100
    if args.data_set == "INAT":
        ds = INatDataset(args.data_path, train=is_train, year=2018,
                         category=args.inat_category, transform=transform)
        return ds, ds.nb_classes
    if args.data_set == "INAT19":
        ds = INatDataset(args.data_path, train=is_train, year=2019,
                         category=args.inat_category, transform=transform)
        return ds, ds.nb_classes
    raise ValueError(f"unknown data-set {args.data_set}")


def build_split_dataset(is_train: bool, opt, start_class: int,
                        class_size: int = 5):
    """Class-range subset for continual learning (reference datasets.py:143-156).
    Returns (subset, nb_classes, indices-into-full-dataset)."""
    end_class = start_class + class_size
    dataset, nb_classes = build_dataset(is_train, opt)
    targets = np.asarray(dataset.targets)
    mask = (targets >= start_class) & (targets < end_class)
    indices = np.nonzero(mask)[0]
    return Subset(dataset, indices), nb_classes, indices
