"""Synthetic datasets (port of `pipeedge_tpu/utils/data.py`, the parts the
host runtime uses). With no network and no dataset in the repository, the
inputs are seeded random images (vision models) or token ids (text
models), repeated to the requested length as the reference's
rollover-single-image mode does."""
from __future__ import annotations

from typing import Tuple

import numpy as np


class RolloverTensorDataset:
    """Repeat small arrays to a requested length."""

    def __init__(self, max_size: int, *tensors):
        if not tensors:
            raise ValueError("RolloverTensorDataset needs at least one array")
        self._tensors = tensors
        self._max_size = max_size

    def __len__(self) -> int:
        return self._max_size

    def __getitem__(self, idx) -> Tuple:
        if not 0 <= idx < self._max_size:
            raise IndexError(idx)
        return tuple(t[idx % len(t)] for t in self._tensors)


def synthetic_image_dataset(size: int, shape=(3, 224, 224),
                            n_labels: int = 1000) -> RolloverTensorDataset:
    """Random-image dataset, the same seeded arrays as the JAX package's."""
    rng = np.random.default_rng(0)
    images = rng.normal(size=(min(size, 64),) + shape).astype(np.float32)
    labels = rng.integers(0, n_labels, size=(min(size, 64),))
    return RolloverTensorDataset(size, images, labels)


def synthetic_token_dataset(size: int, seq_len: int = 512,
                            vocab_size: int = 30522,
                            n_labels: int = 2) -> RolloverTensorDataset:
    """Random token-id dataset (int32 ids), the same seeded arrays as the
    JAX package's."""
    rng = np.random.default_rng(0)
    ids = rng.integers(0, vocab_size,
                       size=(min(size, 64), seq_len)).astype(np.int32)
    labels = rng.integers(0, n_labels, size=(min(size, 64),))
    return RolloverTensorDataset(size, ids, labels)


def batch_dataset(dataset, ubatch_size: int):
    """Yield (inputs [u, ...], labels [u]) microbatches, FIFO order."""
    n = len(dataset)
    for start in range(0, n - ubatch_size + 1, ubatch_size):
        items = [dataset[i] for i in range(start, start + ubatch_size)]
        inputs = np.stack([x for x, _ in items])
        labels = np.asarray([y for _, y in items])
        yield inputs, labels
