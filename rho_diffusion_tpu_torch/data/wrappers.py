"""MNIST / CIFAR-10 dataset wrappers (the port's copy of
``rho_diffusion_tpu/data/wrappers.py``).

They parse the standard on-disk formats directly (MNIST idx files, optionally
gzipped, and CIFAR-10 python pickle batches) and never download: a missing
file raises with the expected layout. Output: channels-LAST float32 in
[-1, 1]; labels are int class ids over a ``labels: 0..9`` parameter space.
"""
from __future__ import annotations

import gzip
import pickle
from pathlib import Path

import numpy as np

from rho_diffusion_tpu_torch.data.base import UnivariateDataset
from rho_diffusion_tpu_torch.data.parameter_space import DiscreteParameterSpace
from rho_diffusion_tpu_torch.registry import registry


def _open_maybe_gz(path: Path):
    if path.suffix == ".gz" or not path.exists() and path.with_suffix(path.suffix + ".gz").exists():
        p = path if path.suffix == ".gz" else path.with_suffix(path.suffix + ".gz")
        return gzip.open(p, "rb")
    return open(path, "rb")


def _read_idx(path: Path) -> np.ndarray:
    """Parse an MNIST idx file (optionally .gz)."""
    with _open_maybe_gz(path) as f:
        magic = int.from_bytes(f.read(4), "big")
        ndim = magic & 0xFF
        shape = [int.from_bytes(f.read(4), "big") for _ in range(ndim)]
        return np.frombuffer(f.read(), dtype=np.uint8).reshape(shape)


@registry.register_dataset("MNISTDataset")
class MNISTDataset(UnivariateDataset):
    """MNIST from raw idx files (reference wrappers.py:78-116)."""

    parameter_space = DiscreteParameterSpace(param_dict={"labels": list(range(10))})

    def __init__(self, root: str = "datasets/mnist", train: bool = True, **_) -> None:
        root_p = Path(root)
        split = "train" if train else "t10k"
        img_path = root_p / f"{split}-images-idx3-ubyte"
        lbl_path = root_p / f"{split}-labels-idx1-ubyte"
        for p in (img_path, lbl_path):
            if not p.exists() and not p.with_suffix(p.suffix + ".gz").exists():
                raise FileNotFoundError(
                    f"MNIST idx file '{p}' not found; nothing is downloaded: place "
                    f"the standard MNIST idx files (optionally gzipped) under '{root}'.",
                )
        self.images = _read_idx(img_path)  # [N, 28, 28] uint8
        self.labels = _read_idx(lbl_path)  # [N] uint8

    def __len__(self) -> int:
        return self.images.shape[0]

    def __getitem__(self, idx: int):
        img = self.images[idx].astype(np.float32) / 255.0 * 2.0 - 1.0
        return img[..., None], np.int32(self.labels[idx])


@registry.register_dataset("CIFAR10Dataset")
class CIFAR10Dataset(UnivariateDataset):
    """CIFAR-10 from python pickle batches (reference wrappers.py:37-76)."""

    parameter_space = DiscreteParameterSpace(param_dict={"labels": list(range(10))})

    def __init__(self, root: str = "datasets/cifar-10-batches-py", train: bool = True, **_) -> None:
        root_p = Path(root)
        names = [f"data_batch_{i}" for i in range(1, 6)] if train else ["test_batch"]
        paths = [root_p / n for n in names]
        missing = [str(p) for p in paths if not p.exists()]
        if missing:
            raise FileNotFoundError(
                f"CIFAR-10 batch files missing: {missing}; nothing is downloaded: "
                f"place the extracted 'cifar-10-batches-py' directory at '{root}'.",
            )
        images, labels = [], []
        for p in paths:
            with open(p, "rb") as f:
                batch = pickle.load(f, encoding="bytes")
            images.append(np.asarray(batch[b"data"], dtype=np.uint8))
            labels.extend(batch[b"labels"])
        data = np.concatenate(images).reshape(-1, 3, 32, 32)
        self.images = data.transpose(0, 2, 3, 1)  # channels-last
        self.labels = np.asarray(labels, dtype=np.int32)

    def __len__(self) -> int:
        return self.images.shape[0]

    def __getitem__(self, idx: int):
        img = self.images[idx].astype(np.float32) / 255.0 * 2.0 - 1.0
        return img, np.int32(self.labels[idx])
