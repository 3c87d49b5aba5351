"""Non-i.i.d. data partitioning (paper §VI).

The paper draws per-device class proportions Z_i = z_i / sum(z) with
z_i ~ Gamma(rho * Zbar_i, 1) — i.e. a Dirichlet(rho * Zbar) mixture.
Small rho => near single-class devices; large rho => i.i.d.
"""
from __future__ import annotations

import numpy as np


def gamma_class_proportions(
    num_devices: int, class_prior: np.ndarray, rho: float, seed: int = 0
) -> np.ndarray:
    """(num_devices, num_classes) row-stochastic class mixtures (paper's model)."""
    rng = np.random.default_rng(seed)
    shape = np.maximum(rho * np.asarray(class_prior, np.float64), 1e-6)
    z = rng.gamma(shape=np.broadcast_to(shape, (num_devices, len(class_prior))), scale=1.0)
    z = np.maximum(z, 1e-12)
    return (z / z.sum(axis=1, keepdims=True)).astype(np.float32)


def dirichlet_partition(
    labels: np.ndarray, num_devices: int, rho: float, seed: int = 0
) -> list[np.ndarray]:
    """Split sample indices across devices with Dirichlet(rho) class mixtures."""
    rng = np.random.default_rng(seed)
    classes = np.unique(labels)
    prior = np.array([np.mean(labels == c) for c in classes])
    mix = gamma_class_proportions(num_devices, prior, rho, seed)
    per_class = {c: rng.permutation(np.flatnonzero(labels == c)) for c in classes}
    offsets = {c: 0 for c in classes}
    n_per_dev = len(labels) // num_devices
    out = []
    for d in range(num_devices):
        want = (mix[d] * n_per_dev).astype(int)
        want[-1] = max(n_per_dev - want[:-1].sum(), 0)
        idx = []
        for c, w in zip(classes, want):
            pool = per_class[c]
            take = pool[offsets[c] : offsets[c] + w]
            # wrap around if a class is exhausted (keeps sizes equal)
            if len(take) < w:
                take = np.concatenate([take, pool[: w - len(take)]])
            offsets[c] = (offsets[c] + w) % max(len(pool), 1)
            idx.append(take)
        out.append(rng.permutation(np.concatenate(idx)).astype(np.int64))
    return out
