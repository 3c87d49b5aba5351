"""Model registry: one interface over the ported architecture families.

``build_model(cfg)`` returns a ``Model`` whose functions close over
nothing — params and caches are explicit dicts of tensors — so the AFL
core can vmap them over devices.  Every family of the reference is here:
the paper's two models (vision: ResNet-9; trajectory: LaneGCN) and the
LLM families (dense, MoE, ssm, hybrid, audio enc-dec, VLM);
``load_params`` carries a reference parameter tree (numpy arrays) over.
``input_specs`` gives a step's inputs at an ``InputShape`` as meta tensors
(shapes and dtypes, no memory), the reference's ``ShapeDtypeStruct``s.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.sharding.rules import init_params, torch_dtype
from repro_torch.utils.tree import TreeLayout, tree_flatten, tree_unflatten


@dataclasses.dataclass(eq=False)
class Model:
    cfg: ModelConfig
    specs: dict
    loss_fn: Callable  # (params, cfg, batch) -> scalar loss
    forward: Callable
    decode_step: Optional[Callable] = None  # (params, cfg, cache, token, pos)
    prefill: Optional[Callable] = None
    init_cache: Optional[Callable] = None  # (cfg, batch, max_seq, device)
    encode: Optional[Callable] = None  # enc-dec only

    def init(self, gen: torch.Generator, device="cpu") -> dict:
        return init_params(self.specs, gen, torch_dtype(self.cfg.param_dtype),
                           device)

    @functools.cached_property
    def layout(self) -> TreeLayout:
        """Leaf paths, shapes and flat offsets in flatten order."""
        return TreeLayout.of(self.specs, shape_of=lambda s: s.shape)

    def num_params(self) -> int:
        return sum(math.prod(s.shape) for s in tree_flatten(self.specs)[1])


def build_model(cfg: ModelConfig) -> Model:
    if cfg.family == "vision":
        from repro_torch.models import resnet as R

        return Model(cfg, R.param_specs(cfg), R.loss_fn, R.forward)
    if cfg.family == "trajectory":
        from repro_torch.models import lanegcn as G

        return Model(cfg, G.param_specs(cfg), G.loss_fn, G.forward)
    if cfg.family in ("dense", "moe"):
        from repro_torch.models import transformer as T

        return Model(cfg, T.param_specs(cfg), T.loss_fn, T.forward,
                     decode_step=T.decode_step, prefill=T.prefill,
                     init_cache=T.init_cache)
    if cfg.family == "vlm":
        from repro_torch.models import vlm as V

        return Model(cfg, V.param_specs(cfg), V.loss_fn, V.forward,
                     decode_step=V.decode_step, prefill=V.prefill,
                     init_cache=V.init_cache)
    if cfg.family == "ssm":
        from repro_torch.models import mamba2 as M

        return Model(cfg, M.param_specs(cfg), M.loss_fn, M.forward,
                     decode_step=M.decode_step, prefill=M.prefill,
                     init_cache=M.init_cache)
    if cfg.family == "hybrid":
        from repro_torch.models import hybrid as H

        return Model(cfg, H.param_specs(cfg), H.loss_fn, H.forward,
                     decode_step=H.decode_step, prefill=H.prefill,
                     init_cache=H.init_cache)
    if cfg.family == "audio":
        from repro_torch.models import encdec as E

        return Model(cfg, E.param_specs(cfg), E.loss_fn, E.forward,
                     decode_step=E.decode_step, prefill=E.prefill,
                     init_cache=E.init_cache, encode=E.encode)
    raise ValueError(f"unknown family {cfg.family!r}")


def _to_tensor(leaf, dtype: torch.dtype, device) -> torch.Tensor:
    """A numpy leaf as a tensor; bf16 leaves (numpy dtype ``bfloat16`` of
    ml_dtypes, which torch cannot read) are carried over bit for bit."""
    a = np.asarray(leaf)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(device=device, dtype=dtype)


def load_params(model: Model, tree, device="cpu") -> dict:
    """The reference's parameter tree (numpy arrays) as the port's tensors,
    each in its spec's dtype (``param_dtype`` unless the spec names one:
    int8 experts and their f32 scales stay so).

    Checks the leaf paths (in flatten order) and shapes against the
    model's specs and raises ``ValueError`` on any mismatch.
    """
    paths, leaves = tree_flatten(tree)
    layout = model.layout
    if tuple(paths) != layout.paths:
        raise ValueError(f"leaf paths {paths} != model's {list(layout.paths)}")
    for path, leaf, shape in zip(paths, leaves, layout.shapes):
        if tuple(np.shape(leaf)) != shape:
            raise ValueError(f"leaf {'/'.join(path)}: shape "
                             f"{tuple(np.shape(leaf))} != spec {shape}")
    dt = torch_dtype(model.cfg.param_dtype)
    dts = [torch_dtype(s.dtype) if s.dtype else dt
           for s in tree_flatten(model.specs)[1]]
    return tree_unflatten(paths, [_to_tensor(l, d, device)
                                  for l, d in zip(leaves, dts)])


# ---------------------------------------------------------------------------
# Input specs (meta tensors + logical dims) per (arch, input shape)
# ---------------------------------------------------------------------------

N_IMG_PATCHES = 256  # stub vision patches for VLM train/prefill


def input_specs(cfg: ModelConfig, shape: InputShape):
    """Returns (dict of meta tensors, dict of logical dims) for the step
    inputs (excluding params and caches), the reference's tree: train and
    prefill take int32 ``tokens`` (and, for train, ``labels``) of (B, S),
    the VLM ``min(256, S // 2)`` bf16 ``vision_embeds`` ahead of S - n_img
    text tokens, the audio family bf16 ``frames`` of (B, encoder_seq,
    d_model); decode takes ``token`` (B,) and ``pos`` ()."""
    b, s = shape.global_batch, shape.seq_len

    def meta(shp, dt=torch.int32):
        return torch.empty(shp, dtype=dt, device="meta")

    if shape.kind in ("train", "prefill"):
        if cfg.family == "vlm":
            n_img = min(N_IMG_PATCHES, s // 2)
            n_txt = s - n_img
            tree = {
                "tokens": meta((b, n_txt)),
                "labels": meta((b, n_txt)),
                "vision_embeds": meta((b, n_img, cfg.d_model), torch.bfloat16),
            }
            dims = {
                "tokens": ("batch", "seq"),
                "labels": ("batch", "seq"),
                "vision_embeds": ("batch", "seq", "embed"),
            }
        elif cfg.family == "audio":
            tree = {
                "tokens": meta((b, s)),
                "labels": meta((b, s)),
                "frames": meta((b, cfg.encoder_seq, cfg.d_model), torch.bfloat16),
            }
            dims = {
                "tokens": ("batch", "seq"),
                "labels": ("batch", "seq"),
                "frames": ("batch", "pos", "embed"),
            }
        else:
            tree = {"tokens": meta((b, s)), "labels": meta((b, s))}
            dims = {"tokens": ("batch", "seq"), "labels": ("batch", "seq")}
        if shape.kind == "prefill":
            tree.pop("labels")
            dims.pop("labels")
        return tree, dims

    # decode: one new token against a seq_len-deep cache
    return {"token": meta((b,)), "pos": meta(())}, {"token": ("batch",),
                                                    "pos": ()}


def demo_batch(cfg: ModelConfig, batch: int, seq: int,
               rng: np.random.Generator):
    """Concrete small arrays for smoke tests (the reference's draws)."""
    if cfg.family == "vision":
        return {
            "images": rng.normal(0, 1, (batch, 32, 32, 3)).astype(np.float32),
            "labels": rng.integers(0, cfg.vocab_size, batch).astype(np.int32),
        }
    if cfg.family == "trajectory":
        return {
            "past": rng.normal(0, 1, (batch, 20, 2)).astype(np.float32),
            "lanes": rng.normal(0, 1, (batch, 32, 2)).astype(np.float32),
            "future": rng.normal(0, 1, (batch, 30, 2)).astype(np.float32),
        }
    out = {
        "tokens": rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32),
        "labels": rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32),
    }
    if cfg.family == "vlm":
        n_img = 16
        out["vision_embeds"] = rng.normal(
            0, 0.02, (batch, n_img, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        out["frames"] = rng.normal(
            0, 0.02, (batch, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return out
