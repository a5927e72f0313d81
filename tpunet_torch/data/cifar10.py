"""CIFAR-10 loading: a framework-free copy of ``tpunet/data/cifar10.py``.

The dataset is read from the standard ``cifar-10-batches-py`` pickle
layout (what torchvision's download produces) and kept in host memory
(50k x 32x32x3 uint8 = 150 MB). A deterministic synthetic dataset with
CIFAR-10's shapes stands in when the real data is absent; for one seed
it is bit-equal to tpunet's. ``get_dataset`` also serves the token
datasets of ``tpunet_torch.data.lm``.
"""

from __future__ import annotations

import os
import pickle
import tarfile
from typing import Tuple

import numpy as np

from tpunet_torch.config import DataConfig
from tpunet_torch.data.download import BATCH_DIR as _BATCH_DIR
from tpunet_torch.data.download import TARBALL as _TARBALL

Arrays = Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]


def _read_batch(path: str) -> Tuple[np.ndarray, np.ndarray]:
    with open(path, "rb") as f:
        d = pickle.load(f, encoding="bytes")
    data = d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)  # NHWC
    labels = np.asarray(d[b"labels"], dtype=np.int32)
    return np.ascontiguousarray(data), labels


def load_cifar10(data_dir: str, download: bool = True) -> Arrays:
    """Load CIFAR-10 from ``data_dir``, downloading (checksum-verified)
    and/or extracting the tarball when needed.

    Returns (train_x[50000,32,32,3] u8, train_y, test_x[10000,...], test_y).
    """
    from tpunet_torch.data.download import ensure_cifar10

    data_dir = ensure_cifar10(os.path.expanduser(data_dir),
                              download=download)
    batch_dir = os.path.join(data_dir, _BATCH_DIR)
    tarball = os.path.join(data_dir, _TARBALL)
    if not os.path.isdir(batch_dir) and os.path.exists(tarball):
        with tarfile.open(tarball, "r:gz") as tf:
            tf.extractall(data_dir)
    if not os.path.isdir(batch_dir):
        raise FileNotFoundError(
            f"CIFAR-10 not found under {data_dir!r} (expected "
            f"{_BATCH_DIR}/ or {_TARBALL}).")
    xs, ys = [], []
    for i in range(1, 6):
        x, y = _read_batch(os.path.join(batch_dir, f"data_batch_{i}"))
        xs.append(x)
        ys.append(y)
    train_x = np.concatenate(xs)
    train_y = np.concatenate(ys)
    test_x, test_y = _read_batch(os.path.join(batch_dir, "test_batch"))
    return train_x, train_y, test_x, test_y


def synthetic_cifar10(n_train: int = 50_000, n_test: int = 10_000,
                      num_classes: int = 10, seed: int = 0) -> Arrays:
    """Deterministic class-separable stand-in with CIFAR-10 shapes.

    Each class is a fixed low-frequency color pattern plus noise, so a
    model can actually fit it.
    """
    rng = np.random.default_rng(seed)
    protos = rng.uniform(40, 215, size=(num_classes, 8, 8, 3))

    def make(n, salt):
        r = np.random.default_rng(seed + salt)
        y = r.integers(0, num_classes, size=n).astype(np.int32)
        base = protos[y]                                   # (n, 8, 8, 3)
        img = np.repeat(np.repeat(base, 4, axis=1), 4, axis=2)
        img = img + r.normal(0, 24, size=img.shape)
        return np.clip(img, 0, 255).astype(np.uint8), y

    train_x, train_y = make(n_train, 1)
    test_x, test_y = make(n_test, 2)
    return train_x, train_y, test_x, test_y


def get_dataset(cfg: DataConfig) -> Arrays:
    if cfg.dataset in ("synthetic_lm", "text_lm"):
        from tpunet_torch.data.lm import get_lm_dataset
        return get_lm_dataset(cfg)
    if cfg.dataset == "synthetic":
        return synthetic_cifar10(n_train=cfg.synthetic_train_size,
                                 n_test=cfg.synthetic_test_size)
    if cfg.dataset == "cifar10":
        return load_cifar10(cfg.data_dir, download=cfg.download)
    raise ValueError(f"unknown dataset {cfg.dataset!r}")
