"""Flat-npz pytree checkpointing with step directories.

Layout: <dir>/step_<n>/arrays.npz + tree.json (key paths + dtypes).
The reference's layout, so either package reads the other's checkpoints.
Tensors are moved to the host and written via ``np.savez`` with
'/'-joined key paths; bfloat16 leaves (which numpy has no type for) are
written as their exact float32 values.
"""
from __future__ import annotations

import json
import os
import re

import numpy as np
import torch


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}#{i}/"))
    elif isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        out[prefix[:-1]] = t.numpy()
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def _unflatten(flat: dict):
    root: dict = {}
    for path, arr in flat.items():
        keys = path.split("/")
        node = root
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = arr

    def rebuild(node):
        if not isinstance(node, dict):
            return node
        if node and all(re.fullmatch(r"#\d+", k) for k in node):
            return [rebuild(node[f"#{i}"]) for i in range(len(node))]
        return {k: rebuild(v) for k, v in node.items()}

    return rebuild(root)


def save(directory: str, step: int, tree) -> str:
    path = os.path.join(directory, f"step_{step:08d}")
    os.makedirs(path, exist_ok=True)
    flat = _flatten(tree)
    np.savez(os.path.join(path, "arrays.npz"), **flat)
    meta = {k: str(v.dtype) for k, v in flat.items()}
    with open(os.path.join(path, "tree.json"), "w") as f:
        json.dump({"step": step, "dtypes": meta}, f)
    return path


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = [
        int(d.split("_")[1])
        for d in os.listdir(directory)
        if d.startswith("step_") and os.path.isfile(os.path.join(directory, d, "arrays.npz"))
    ]
    return max(steps) if steps else None


def restore(directory: str, step: int | None = None):
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    path = os.path.join(directory, f"step_{step:08d}", "arrays.npz")
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    return _unflatten(flat), step
