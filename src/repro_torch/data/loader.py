"""Batch iteration utilities for the federated simulation."""
from __future__ import annotations

import numpy as np


def batch_iterator(arrays: dict, batch_size: int, seed: int = 0):
    """Infinite shuffled mini-batch iterator over a dict of same-length arrays."""
    n = len(next(iter(arrays.values())))
    rng = np.random.default_rng(seed)
    while True:
        order = rng.permutation(n)
        for i in range(0, n - batch_size + 1, batch_size):
            sel = order[i : i + batch_size]
            yield {k: v[sel] for k, v in arrays.items()}


class DeviceLoader:
    """Per-device mini-batch sampler (device n draws B_n^(r) from D_n)."""

    def __init__(self, device_arrays: list[dict], batch_size: int, seed: int = 0):
        for i, arrs in enumerate(device_arrays):
            n = len(next(iter(arrs.values())))
            if n < batch_size:  # batch_iterator would never yield
                raise ValueError(f"device {i} holds {n} samples, fewer than "
                                 f"the batch size {batch_size}")
        self._iters = [
            batch_iterator(arrs, batch_size, seed + 7 * i)
            for i, arrs in enumerate(device_arrays)
        ]

    def __len__(self):
        return len(self._iters)

    def sample(self, device: int) -> dict:
        return next(self._iters[device])

    def sample_all(self) -> dict:
        """Stacked batch for all devices: leaves get a leading device axis."""
        batches = [next(it) for it in self._iters]
        return {
            k: np.stack([b[k] for b in batches], axis=0) for k in batches[0]
        }
