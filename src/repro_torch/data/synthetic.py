"""Synthetic CIFAR-10 stand-in (numpy; the reference's generator, exactly).

Class-conditional images: each class has a fixed random template; samples
are template + Gaussian noise.  A model that learns the 10 templates
reaches high accuracy, so FL convergence dynamics are preserved.  The
trajectory and token generators wait for their model families.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SyntheticCifar:
    num_classes: int = 10
    image_size: int = 32
    channels: int = 3
    noise: float = 0.35
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self.templates = rng.normal(
            0, 1, (self.num_classes, self.image_size, self.image_size, self.channels)
        ).astype(np.float32)

    def sample(self, rng: np.random.Generator, labels: np.ndarray):
        imgs = self.templates[labels] + rng.normal(
            0, self.noise, (len(labels), self.image_size, self.image_size, self.channels)
        ).astype(np.float32)
        return imgs

    def make_split(self, n: int, class_probs: np.ndarray | None = None, seed: int = 1):
        """Draw n (image, label) pairs with the given class mixture."""
        rng = np.random.default_rng(seed)
        p = class_probs if class_probs is not None else np.full(self.num_classes, 1 / self.num_classes)
        labels = rng.choice(self.num_classes, size=n, p=p / p.sum())
        return self.sample(rng, labels), labels.astype(np.int32)
