"""Qwen2-VL language backbone [arXiv:2409.12191]; the port of
``repro/models/vlm.py``.

The ViT/merger vision frontend is a STUB, as in the reference:
``vision_embeds`` (B, n_img, d_model) arrive precomputed and are spliced in
front of the text-token embeddings.  M-RoPE 3D positions: image patches
get (t=0, h=row, w=col); text tokens continue temporally after the image
with h == w == t.  Serving is text-only, through the transformer's
prefill and decode (all three position streams then coincide).
"""
from __future__ import annotations

import torch

from repro_torch.models import layers as L
from repro_torch.models import transformer as T

param_specs = T.param_specs
init_cache = T.init_cache
decode_step = T.decode_step
prefill = T.prefill


def mrope_positions(batch: int, n_img: int, n_text: int, grid: int,
                    device=None) -> torch.Tensor:
    """(3, B, n_img + n_text) position ids for an image-then-text stream."""
    grid = max(grid, 1)
    img = torch.arange(n_img, device=device)
    start = grid if n_img else 0
    t_text = start + torch.arange(n_text, device=device)
    t = torch.cat([torch.zeros(n_img, dtype=torch.int64, device=device), t_text])
    h = torch.cat([img // grid, t_text])
    w = torch.cat([img % grid, t_text])
    pos = torch.stack([t, h, w]).to(torch.int32)  # (3, S)
    return pos[:, None, :].expand(3, batch, n_img + n_text)


def forward(params, cfg, tokens, *, vision_embeds=None, positions=None,
            model_axis=None, **kw):
    """The transformer's forward with the vision embeddings spliced in
    front (``model_axis`` as there)."""
    if vision_embeds is None:
        return T.forward(params, cfg, tokens, positions=positions,
                         model_axis=model_axis, **kw)
    text = L.embed(params, cfg, tokens, model_axis)
    x = torch.cat([vision_embeds.to(cfg.activation_dtype), text], dim=1)
    b, n_img = vision_embeds.shape[:2]
    grid = int(max(n_img, 1) ** 0.5) or 1
    if positions is None:
        positions = mrope_positions(b, n_img, tokens.shape[1], grid, x.device)
    return T.forward(params, cfg, embeds=x, positions=positions,
                     model_axis=model_axis, **kw)


def loss_fn(params, cfg, batch, model_axis=None, batch_axis=None):
    """Cross-entropy on the text positions only (vision positions
    unlabeled), plus an MoE's aux loss (``batch_axis``: as
    ``transformer.loss_fn``'s)."""
    logits, aux = forward(params, cfg, batch["tokens"],
                          vision_embeds=batch.get("vision_embeds"),
                          model_axis=model_axis, batch_axis=batch_axis)
    n_img = batch["vision_embeds"].shape[1] if "vision_embeds" in batch else 0
    return (L.cross_entropy(logits[:, n_img:], batch["labels"], cfg,
                            model_axis)
            + cfg.router_aux_loss * aux)
