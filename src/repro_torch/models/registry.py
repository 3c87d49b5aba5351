"""Model registry: one interface over the ported architecture families.

``build_model(cfg)`` returns a ``Model`` whose functions close over
nothing — params and caches are explicit dicts of tensors — so the AFL
core can vmap them over devices.  Every family of the reference is here:
the paper's two models (vision: ResNet-9; trajectory: LaneGCN) and the
LLM families (dense, MoE, ssm, hybrid, audio enc-dec, VLM);
``load_params`` carries a reference parameter tree (numpy arrays) over,
``local_params`` cuts a rank's blocks out of a tree (``Model.blocks``'s:
every family's leaves under the rules), ``local_cache`` a rank's
model-axis part out of a whole serving cache and ``data_cache`` its
data-axis block.
``param_axes`` and ``cache_axes`` give the logical dims that the sharding
rules (``sharding/rules.py``) place.
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
from repro_torch.sharding import rules as R
from repro_torch.sharding.rules import init_params, torch_dtype
from repro_torch.utils.tree import TreeLayout, tree_flatten, tree_unflatten


@dataclasses.dataclass(eq=False)
class Model:
    cfg: ModelConfig
    specs: dict
    # (params, cfg, batch, model_axis=None, batch_axis=None) -> scalar loss
    loss_fn: Callable
    forward: Callable
    decode_step: Optional[Callable] = None  # (params, cfg, cache, token, pos)
    prefill: Optional[Callable] = None
    init_cache: Optional[Callable] = None  # (cfg, batch, max_seq, device)
    cache_axes: Optional[Callable] = None  # (cfg) -> logical dims tree
    encode: Optional[Callable] = None  # enc-dec only

    def init(self, gen: torch.Generator, device="cpu", blocks=None) -> dict:
        """Parameters drawn from ``gen``; ``blocks`` (``self.blocks``'s)
        keeps a rank's block of each leaf, from the same draws."""
        return init_params(self.specs, gen, torch_dtype(self.cfg.param_dtype),
                           device, blocks)

    def param_axes(self) -> dict:
        return R.axes_tree(self.specs)

    def param_pspecs(self, rules, mesh) -> dict:
        """Each leaf's spec under ``rules`` on ``mesh``."""
        return R.pspec_tree(self.param_axes(), R.shapes_tree(self.specs),
                            rules, mesh)

    def blocks(self, rules, mesh, coords: dict) -> dict:
        """The per-dim slices of each leaf that the rank at ``coords``
        holds."""
        return R.block_tree(self.param_pspecs(rules, mesh),
                            R.shapes_tree(self.specs), mesh, coords)

    @functools.cached_property
    def layout(self) -> TreeLayout:
        """Leaf paths, shapes and flat offsets in flatten order."""
        return TreeLayout.of(self.specs, shape_of=lambda s: s.shape)

    def num_params(self) -> int:
        return sum(math.prod(s.shape) for s in tree_flatten(self.specs)[1])


def _transformer_cache_axes(cfg) -> dict:
    ax = {
        "k": ("layers", "batch", "seq", "kv_heads", "head_dim"),
        "v": ("layers", "batch", "seq", "kv_heads", "head_dim"),
        "pos": ("batch", "seq"),
        "length": (),
    }
    if cfg.kv_cache_dtype == "int8":
        ax["k_scale"] = ("layers", "batch", "seq", "kv_heads")
        ax["v_scale"] = ("layers", "batch", "seq", "kv_heads")
    return ax


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
                     init_cache=T.init_cache,
                     cache_axes=_transformer_cache_axes)
    if cfg.family == "vlm":
        from repro_torch.models import vlm as V

        return Model(cfg, V.param_specs(cfg), V.loss_fn, V.forward,
                     decode_step=V.decode_step, prefill=V.prefill,
                     init_cache=V.init_cache,
                     cache_axes=_transformer_cache_axes)
    if cfg.family == "ssm":
        from repro_torch.models import mamba2 as M

        return Model(cfg, M.param_specs(cfg), M.loss_fn, M.forward,
                     decode_step=M.decode_step, prefill=M.prefill,
                     init_cache=M.init_cache, cache_axes=M.cache_axes)
    if cfg.family == "hybrid":
        from repro_torch.models import hybrid as H

        return Model(cfg, H.param_specs(cfg), H.loss_fn, H.forward,
                     decode_step=H.decode_step, prefill=H.prefill,
                     init_cache=H.init_cache, cache_axes=H.cache_axes)
    if cfg.family == "audio":
        from repro_torch.models import encdec as E

        return Model(cfg, E.param_specs(cfg), E.loss_fn, E.forward,
                     decode_step=E.decode_step, prefill=E.prefill,
                     init_cache=E.init_cache, cache_axes=E.cache_axes,
                     encode=E.encode)
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


def local_params(model: Model, params: dict, blocks: dict,
                 lead: int = 0) -> dict:
    """A rank's blocks of a whole parameter tree whose leaves carry
    ``lead`` leading dims (``Model.blocks``'s slices; copies, so the
    whole tree can be freed)."""
    paths, leaves = tree_flatten(params)
    bl = tree_flatten(blocks)[1]
    pre = (slice(None),) * lead
    return tree_unflatten(paths, [l[pre + b].clone()
                                  for l, b in zip(leaves, bl)])


def local_cache(model: Model, cache: dict, model_axis) -> dict:
    """A rank's part of a whole serving cache (``init_cache``'s without a
    model axis), the cache ``init_cache(model_axis=)`` makes: the kv heads
    of its q heads in the attention slots, the enc-dec's cross-attention
    slots among them (``layers.head_plan``), or where the rules cut their
    ``head_dim``, every kv head over its block of the slots
    (``layers.cache_block``: of the positions' slots, of the cross
    cache's own; the positions stay whole), and where it runs its block
    of the SSD heads (``mamba2.ssm_split``) its block of ``conv_x`` and of
    ``ssm``; the rest as it is."""
    from repro_torch.models import layers as L
    from repro_torch.models import mamba2 as M2

    cfg = model.cfg
    out = dict(cache)
    if cfg.num_heads:
        idx = list(L.cache_kv(cfg, model_axis))
        for key in ("k", "v", "k_scale", "v_scale", "attn_k", "attn_v", "xk",
                    "xv"):
            if key in cache:
                slots = cache[key].shape[2] if key in ("xk", "xv") else \
                    cache["pos"].shape[1]
                blk = L.cache_block(cfg, model_axis, slots) or slice(None)
                out[key] = cache[key][:, :, blk][:, :, :, idx]
    if "ssm" in cache and M2.ssm_split(cfg, model_axis):
        m, r = model_axis.size, model_axis.rank
        for key, dim in (("conv_x", 3), ("ssm", 2)):
            per = cache[key].shape[dim] // m
            out[key] = cache[key].narrow(dim, r * per, per)
    return out


def data_cache(model: Model, cache: dict, mesh, coords: dict) -> dict:
    """A rank's block on a serve step's ``data`` axis of a whole serving
    cache: each leaf cut by ``RULES_SERVE``'s ``data`` entry
    (``sharding/rules.py::data_blocks``; its rows of the batch, or where
    the batch does not divide its block of the slots), as copies;
    ``length`` as it is.  ``local_cache`` then cuts its model part."""
    ten = {k: v for k, v in cache.items() if isinstance(v, torch.Tensor)}
    axes = model.cache_axes(model.cfg)
    bl = R.data_blocks({k: axes[k] for k in ten}, ten, mesh, coords)
    return {k: v[bl[k]].clone() if k in ten else v for k, v in cache.items()}


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
