"""Synthetic stand-ins for CIFAR-10 and Argoverse (numpy; the reference's
generators, exactly).

* ``SyntheticCifar`` — class-conditional images: each class has a fixed
  random template; samples are template + Gaussian noise.  A model that
  learns the 10 templates reaches high accuracy, so FL convergence
  dynamics are preserved.
* ``SyntheticTrajectories`` — kinematic vehicle tracks (constant turn rate
  + noise) with lane-centreline context; target = next 30 positions at
  10 Hz, metric = ADE (paper §VI-C).
* ``SyntheticTokens`` — order-1 Markov token streams over the vocab with a
  low-rank transition (the federated LM fine-tuning corpus).  It holds a
  V x V float64 transition matrix, so it serves reduced vocabularies.
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


@dataclasses.dataclass
class SyntheticTrajectories:
    """Argoverse-like motion forecasting: 20 past -> 30 future steps @10Hz."""

    past: int = 20
    future: int = 30
    map_nodes: int = 32
    dt: float = 0.1
    seed: int = 0

    def make_split(self, n: int, seed: int = 1):
        rng = np.random.default_rng(seed)
        speed = rng.uniform(3.0, 20.0, (n, 1))
        heading0 = rng.uniform(-np.pi, np.pi, (n, 1))
        turn = rng.normal(0.0, 0.08, (n, 1))  # rad/s
        t = np.arange(self.past + self.future) * self.dt
        heading = heading0 + turn * t[None, :]
        vx = speed * np.cos(heading)
        vy = speed * np.sin(heading)
        x = np.cumsum(vx * self.dt, axis=1)
        y = np.cumsum(vy * self.dt, axis=1)
        traj = np.stack([x, y], axis=-1).astype(np.float32)
        traj += rng.normal(0, 0.05, traj.shape).astype(np.float32)
        # centre on the last observed position (Argoverse convention)
        traj = traj - traj[:, self.past - 1 : self.past, :]
        past, future = traj[:, : self.past], traj[:, self.past :]
        # lane centreline context: noisy extrapolation of the heading
        s = np.linspace(0, 3.0, self.map_nodes)[None, :, None]
        lane_dir = np.stack([np.cos(heading[:, self.past - 1]),
                             np.sin(heading[:, self.past - 1])], -1)
        lanes = (s * lane_dir[:, None, :] * speed[:, :, None]).astype(np.float32)
        lanes += rng.normal(0, 0.2, lanes.shape).astype(np.float32)
        return {"past": past, "lanes": lanes, "future": future.astype(np.float32)}


@dataclasses.dataclass
class SyntheticTokens:
    """Order-1 Markov chain over the vocab with a low-rank transition."""

    vocab_size: int = 1024
    rank: int = 8
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        a = rng.normal(0, 1, (self.vocab_size, self.rank))
        b = rng.normal(0, 1, (self.rank, self.vocab_size))
        logits = a @ b / np.sqrt(self.rank)
        self.probs = np.exp(logits - logits.max(-1, keepdims=True))
        self.probs /= self.probs.sum(-1, keepdims=True)

    def make_split(self, n: int, seq_len: int, seed: int = 1):
        rng = np.random.default_rng(seed)
        out = np.zeros((n, seq_len + 1), np.int32)
        out[:, 0] = rng.integers(0, self.vocab_size, n)
        cdf = np.cumsum(self.probs, axis=-1)
        for t in range(seq_len):
            u = rng.random(n)
            out[:, t + 1] = (u[:, None] < cdf[out[:, t]]).argmax(-1)
        return {"tokens": out[:, :-1], "labels": out[:, 1:]}
