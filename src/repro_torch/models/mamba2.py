"""Mamba2 (SSD, state-space duality) blocks [arXiv:2405.21060]; the port of
``repro/models/mamba2.py``.

Chunked SSD: the sequence is split into chunks of ``cfg.ssm_chunk``;
intra-chunk terms use the quadratic (attention-like) form, inter-chunk
terms carry the (H, P, N) state from chunk to chunk.  A forward or
prefill whose length is a multiple of the chunk goes through the
``ssd_scan`` kernel (``kernels/ops.py``); otherwise, and in decode (the
O(1)-per-token recurrent update), the plain code runs, as in the
reference.  Training (``loss_fn``, and so ``afl_round``'s vmapped
gradient) differentiates the chunked formula ``ssd_chunked``, as the
reference does on every backend where it trains: the kernel has no
backward, in the reference as here.

Projections are separate tensors (wz/wx/wB/wC/wdt), as in the reference's
tree.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.remat import checkpoint, full_only
from repro_torch.models.transformer import layer, stack_specs
from repro_torch.sharding.rules import ParamSpec

F32 = torch.float32
HEAD_P = 64  # SSD value-head dim


def dims(cfg):
    d_inner = cfg.ssm_expand * cfg.d_model
    heads = cfg.ssm_heads or d_inner // HEAD_P
    return d_inner, heads, d_inner // heads, cfg.ssm_state


def mamba_specs(cfg) -> dict:
    d_inner, h, p, n = dims(cfg)
    d = cfg.d_model
    k = cfg.conv_kernel
    return {
        "wz": ParamSpec((d, d_inner), ("embed", "ssm_inner")),
        "wx": ParamSpec((d, d_inner), ("embed", "ssm_inner")),
        "wB": ParamSpec((d, n), ("embed", "ssm_state")),
        "wC": ParamSpec((d, n), ("embed", "ssm_state")),
        "wdt": ParamSpec((d, h), ("embed", "ssm_heads")),
        "conv_x": ParamSpec((k, d_inner), ("conv", "ssm_inner"), init="small"),
        "conv_B": ParamSpec((k, n), ("conv", "ssm_state"), init="small"),
        "conv_C": ParamSpec((k, n), ("conv", "ssm_state"), init="small"),
        "dt_bias": ParamSpec((h,), ("ssm_heads",), init="zeros"),
        "a_log": ParamSpec((h,), ("ssm_heads",), init="zeros"),
        "d_skip": ParamSpec((h,), ("ssm_heads",), init="ones"),
        "norm": ParamSpec((d_inner,), ("ssm_inner",), init="ones"),
        "wo": ParamSpec((d_inner, d), ("ssm_inner", "embed")),
    }


def _causal_conv(x, w, state=None):
    """Depthwise causal conv, the sum of shifted products. x: (B,S,C),
    w: (K,C).  If ``state`` (B,K-1,C) is given (decode), returns
    (y, new_state)."""
    k = w.shape[0]
    s = x.shape[1]
    if state is not None:
        xs = torch.cat([state, x], dim=1)  # (B, K-1+S, C)
        new_state = xs[:, -(k - 1):, :] if k > 1 else torch.zeros_like(state)
    else:
        xs = torch.nn.functional.pad(x, (0, 0, k - 1, 0))
        new_state = None
    y = xs[:, 0:s, :] * w[0]
    for i in range(1, k):
        y = y + xs[:, i:i + s, :] * w[i]
    y = L.silu_f32(y)
    return (y, new_state) if state is not None else y


def _segsum(a):
    """a: (..., Q) -> (..., Q, Q) with out[i,j] = sum_{j<k<=i} a_k (i>=j)."""
    q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=a.device))
    return torch.where(mask, diff, -torch.inf)


def ssd_chunked(x, a, b, c, chunk: int):
    """Chunked SSD scan in plain torch (the ``ssd_scan`` kernel's plain
    version, ``kernels/ref.py::ssd_scan_plain``).

    x: (B,S,H,P) discrete inputs (already dt-scaled); a: (B,S,H) log-decays
    (dt * A, negative); b, c: (B,S,N).  Returns y: (B,S,H,P), final state
    (B,H,P,N).  All internals f32, or f64 when x is f64 (an oracle for the
    f32 versions: at chunk 256 the in-chunk cumsums reach |100| and the
    differences of two of them carry ~1e-5 of relative rounding).  The
    reference's four-operand einsums are taken two operands at a time.
    """
    ft = torch.float64 if x.dtype == torch.float64 else F32
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    q = min(chunk, s)
    if s % q:
        raise ValueError(f"sequence {s} is not a multiple of chunk {q}")
    nc = s // q
    xf = x.to(ft).reshape(bsz, nc, q, h, p)
    af = a.to(ft).reshape(bsz, nc, q, h).permute(0, 3, 1, 2)  # (B,H,nc,Q)
    bf = b.to(ft).reshape(bsz, nc, q, n)
    cf = c.to(ft).reshape(bsz, nc, q, n)

    a_cum = torch.cumsum(af, dim=-1)  # (B,H,nc,Q)
    lmat = torch.exp(_segsum(af))  # (B,H,nc,Q,Q)
    # intra-chunk (diagonal blocks)
    cb = torch.einsum("bcln,bcsn->bcls", cf, bf)
    y_diag = torch.einsum("bhcls,bcshp->bclhp", cb[:, None] * lmat, xf)
    # states emitted by each chunk
    decay_states = torch.exp(a_cum[..., -1:] - a_cum)  # (B,H,nc,Q)
    xd = xf * decay_states.permute(0, 2, 3, 1)[..., None]
    states = torch.einsum("bcln,bclhp->bchpn", bf, xd)
    # inter-chunk linear scan
    chunk_decay = torch.exp(a_cum[..., -1])  # (B,H,nc)
    st = torch.zeros((bsz, h, p, n), dtype=ft, device=x.device)
    prevs = []
    for i in range(nc):
        prevs.append(st)
        st = st * chunk_decay[:, :, i, None, None] + states[:, i]
    prevs = torch.stack(prevs, dim=1)  # (B,nc,H,P,N)
    # inter-chunk contribution
    state_decay_out = torch.exp(a_cum).permute(0, 2, 3, 1)[..., None]  # (B,nc,Q,H,1)
    y_off = torch.einsum("bcln,bchpn->bclhp", cf, prevs) * state_decay_out
    y = (y_diag + y_off).reshape(bsz, s, h, p)
    return y, st


def ssd_decode_step(state, x, a, b, c):
    """O(1) recurrent update. state: (B,H,P,N); x: (B,H,P); a: (B,H); b,c: (B,N)."""
    dec = torch.exp(a.to(F32))[..., None, None]
    upd = x.to(F32)[..., None] * b.to(F32)[:, None, None, :]
    new = state * dec + upd
    y = torch.einsum("bhpn,bn->bhp", new, c.to(F32))
    return y.to(x.dtype), new


def softplus(x):
    """``jax.nn.softplus``: log(1 + exp(x)) as ``logaddexp(x, 0)``, with no
    linear cut-off above a threshold (torch's ``softplus`` has one at 20)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def mamba_block(p, cfg, x, conv_state=None, ssm_state=None, collect_cache=False,
                train=False):
    """Full Mamba2 block. x: (B,S,d).

    Training (``train=True``: the chunked formula, differentiable):
    states None -> returns (y, final_ssm_state).
    Prefill (collect_cache): returns (y, conv_tails, final_ssm_state).
    Decode (S==1): pass states -> returns (y, new_conv, new_ssm).
    """
    d_inner, h, pdim, n = dims(cfg)
    dt_ = x.dtype
    z = x @ p["wz"].to(dt_)
    xin = x @ p["wx"].to(dt_)
    bin_ = x @ p["wB"].to(dt_)
    cin = x @ p["wC"].to(dt_)
    dt_raw = x @ p["wdt"].to(dt_)

    decode = conv_state is not None
    if decode:
        xin, cx = _causal_conv(xin, p["conv_x"].to(dt_), conv_state["x"])
        bin_, cb = _causal_conv(bin_, p["conv_B"].to(dt_), conv_state["B"])
        cin, cc = _causal_conv(cin, p["conv_C"].to(dt_), conv_state["C"])
        new_conv = {"x": cx, "B": cb, "C": cc}
    else:
        kk = p["conv_x"].shape[0]
        if collect_cache:  # pre-conv tails become the decode conv state
            new_conv = {
                "x": xin[:, -(kk - 1):, :],
                "B": bin_[:, -(kk - 1):, :],
                "C": cin[:, -(kk - 1):, :],
            }
        xin = _causal_conv(xin, p["conv_x"].to(dt_))
        bin_ = _causal_conv(bin_, p["conv_B"].to(dt_))
        cin = _causal_conv(cin, p["conv_C"].to(dt_))

    dt = softplus(dt_raw.to(F32) + p["dt_bias"].to(F32))
    a = -torch.exp(p["a_log"].to(F32))  # (H,) negative decay rates
    xh = xin.reshape(*xin.shape[:2], h, pdim)
    x_disc = xh.to(F32) * dt[..., None]
    log_decay = dt * a  # (B,S,H)

    if decode:
        y1, new_ssm = ssd_decode_step(
            ssm_state, x_disc[:, 0], log_decay[:, 0], bin_[:, 0], cin[:, 0])
        y = y1[:, None]
    elif not train and x_disc.shape[1] % cfg.ssm_chunk == 0:
        y, new_ssm = ops.ssd_scan(x_disc, log_decay, bin_, cin, cfg.ssm_chunk)
    else:
        y, new_ssm = ssd_chunked(x_disc, log_decay, bin_, cin, cfg.ssm_chunk)
    y = y + xh.to(F32) * p["d_skip"].to(F32)[None, None, :, None]
    y = y.reshape(*xin.shape[:2], d_inner).to(dt_)
    # gated RMSNorm (mamba2): norm(y * silu(z))
    y = L.rms_norm(y * L.silu_f32(z), p["norm"], cfg.norm_eps)
    out = y @ p["wo"].to(dt_)
    if decode or collect_cache:
        return out, new_conv, new_ssm
    return out, new_ssm


# ---------------------------------------------------------------------------
# Full model (attention-free LM)
# ---------------------------------------------------------------------------


def block_specs(cfg) -> dict:
    return {
        "ln": ParamSpec((cfg.d_model,), ("embed",), init="ones"),
        "mamba": mamba_specs(cfg),
    }


def param_specs(cfg) -> dict:
    return {
        "embed": L.embed_specs(cfg),
        "layers": stack_specs(block_specs(cfg), cfg.num_layers),
        "ln_f": ParamSpec((cfg.d_model,), ("embed",), init="ones"),
        "unembed": {
            "w": ParamSpec((cfg.d_model, cfg.vocab_size), ("embed", "vocab"), init="small")
        },
    }


def forward(params, cfg, tokens, *, train=False):
    """Logits and a zero aux loss; ``train=True`` runs the differentiable
    chunked SSD in place of the kernel."""
    x = L.embed(params, cfg, tokens)
    x = layer_stack(params["layers"], cfg, x, range(cfg.num_layers), train)
    x = L.rms_norm(x, params["ln_f"], cfg.norm_eps)
    logits = x @ params["unembed"]["w"].to(x.dtype)
    return logits, torch.zeros((), dtype=F32, device=x.device)


def layer_stack(layers, cfg, x, which, train: bool):
    """Residual Mamba2 layers ``which`` of the stacked ``layers`` over x,
    each under ``cfg.remat``'s checkpoint (``"full"`` only, as in the
    reference; ``models/remat.py``)."""
    def body(lp, x):
        h = L.rms_norm(x, lp["ln"], cfg.norm_eps)
        return x + mamba_block(lp["mamba"], cfg, h, train=train)[0]

    policy = full_only(cfg.remat)
    for i in which:
        x = checkpoint(body, policy, layer(layers, i), x)
    return x


def loss_fn(params, cfg, batch):
    logits, _ = forward(params, cfg, batch["tokens"], train=True)
    return L.cross_entropy(logits, batch["labels"])


def init_cache(cfg, batch: int, max_seq: int = 0, device="cpu"):
    """Recurrent cache: conv tails + SSD state per layer. O(1) in seq length."""
    d_inner, h, p, n = dims(cfg)
    k = cfg.conv_kernel
    lc = cfg.num_layers
    dt = cfg.activation_dtype
    return {
        "conv_x": torch.zeros((lc, batch, k - 1, d_inner), dtype=dt, device=device),
        "conv_B": torch.zeros((lc, batch, k - 1, n), dtype=dt, device=device),
        "conv_C": torch.zeros((lc, batch, k - 1, n), dtype=dt, device=device),
        "ssm": torch.zeros((lc, batch, h, p, n), dtype=F32, device=device),
    }


CONV_KEYS = (("conv_x", "x"), ("conv_B", "B"), ("conv_C", "C"))


def prefill(params, cfg, tokens):
    """Run the prompt, return (last-token logits, recurrent cache)."""
    x = L.embed(params, cfg, tokens)
    cache = init_cache(cfg, x.shape[0], device=x.device)
    for i in range(cfg.num_layers):
        lp = layer(params["layers"], i)
        h = L.rms_norm(x, lp["ln"], cfg.norm_eps)
        y, conv, ssm = mamba_block(lp["mamba"], cfg, h, collect_cache=True)
        x = x + y
        for key, short in CONV_KEYS:
            cache[key][i] = conv[short]
        cache["ssm"][i] = ssm
    x = L.rms_norm(x, params["ln_f"], cfg.norm_eps)
    logits = x[:, -1] @ params["unembed"]["w"].to(x.dtype)
    return logits, cache


def decode_step(params, cfg, cache, token, pos=None):
    """One recurrent step. The cache is updated IN PLACE and returned (the
    reference returns new arrays; the values are the same)."""
    x = L.embed(params, cfg, token)[:, None, :]
    for i in range(cfg.num_layers):
        lp = layer(params["layers"], i)
        h = L.rms_norm(x, lp["ln"], cfg.norm_eps)
        conv = {short: cache[key][i] for key, short in CONV_KEYS}
        y, new_conv, new_ssm = mamba_block(
            lp["mamba"], cfg, h, conv_state=conv, ssm_state=cache["ssm"][i])
        x = x + y
        for key, short in CONV_KEYS:
            cache[key][i] = new_conv[short]
        cache["ssm"][i] = new_ssm
    x = L.rms_norm(x, params["ln_f"], cfg.norm_eps)
    logits = (x @ params["unembed"]["w"].to(x.dtype))[:, 0]
    return logits, cache
