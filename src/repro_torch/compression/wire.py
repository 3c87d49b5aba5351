"""Wire format for compressed client uploads (the serve-path payloads); the
port of ``repro/compression/wire.py``.

Every codec produces a *dense dequantised* payload, the right interface
for the simulation engines, where the MES aggregation is one product on
the device.  A streaming aggregation server (``repro_torch/serve``)
receives uploads one at a time instead, so this module defines the
(de)serialisation contract between them:

* ``WirePayload``: one upload on the wire (numpy fields, as in the
  reference): ascending flat coordinates, the value codes, a quantisation
  step, and the header scalars the server needs for staleness-weighted
  mixing (device id, the model-version round ``rnd`` the upload was
  computed against, the billed ``bits``).
* Value codes are ``int32`` carrying either the *b-bit integer grid codes*
  (``b < 32``: the stochastic-rounding output ``q``, dequantised
  server-side as ``q * step``, the codecs' exact float multiply, so decode
  is bit-identical to the dense payload) or the *raw float32 bit pattern*
  (``b == 32``, bitcast, ``step == 1``).
* ``pack_batch`` pads a list of payloads onto static ``(batch, max_k)``
  arrays (pad coordinate = ``s``, dropped by the scatter), which makes the
  server's decompress + aggregate one op over the whole batch.

``encode_upload`` takes a flat tensor or a tree of tensors on any device
(or numpy arrays): it finds the nonzeros on the payload's device and
copies only the k coordinates and values to the host.

Bit accounting mirrors ``base.Compressor``: ``k * (b + ceil(log2 s))``
index+value bits plus one 32-bit scale per quantised message (eq. 7c).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.compression import quant as Q
from repro_torch.utils.tree import tree_flatten

__all__ = ["WirePayload", "encode_upload", "pack_batch", "decode_values",
           "index_bits", "PACKED_KEYS"]

# pack_batch's arrays: the (batch, max_k) int32 blocks, then the (batch,)
# float32 header columns
PACKED_KEYS = ("coords", "codes", "step", "b", "dtau", "mask", "bits")


def index_bits(s: int) -> int:
    """Per-coordinate position overhead on the wire (paper eq. 7c)."""
    return int(math.ceil(math.log2(max(s, 2))))


class WirePayload(NamedTuple):
    """One compressed upload as serialised for the aggregation server."""

    coords: np.ndarray  # (k,) int32 flat coordinate indices, ascending
    codes: np.ndarray  # (k,) int32 grid codes (b<32) or f32 bit patterns
    step: float  # quantisation step (1.0 for raw float values)
    b: float  # value bit-width on the wire (32 = raw float32)
    k: int  # number of shipped coordinates
    device: int = 0  # uploading client id
    rnd: int = 0  # model-version round the upload was computed against
    ok: float = 1.0  # client-side feasibility mask (0 withholds mixing)
    bits: float = 0.0  # billed wire bits (header; k (b + log2 s) + scale)


def _flat_f32(payload) -> torch.Tensor:
    """A flat tensor, a tree of tensors or numpy arrays as one flat f32
    vector on the payload's device (leaves in flatten order)."""
    if isinstance(payload, dict):
        leaves = tree_flatten(payload)[1]
    else:
        leaves = [payload]
    flat = [torch.as_tensor(l).reshape(-1).to(torch.float32) for l in leaves]
    return flat[0] if len(flat) == 1 else torch.cat(flat)


def encode_upload(payload, *, b: float = 32.0, step: float = 1.0,
                  device: int = 0, rnd: int = 0, ok: float = 1.0,
                  max_k: Optional[int] = None) -> WirePayload:
    """Serialise one dense dequantised payload onto the wire.

    ``b``/``step`` come from the codec's per-upload stats (``stats["b"]``
    and ``stats["step"]``); ``b >= 32`` (or a zero step) ships raw float32
    bit patterns instead of grid codes.  Encoding happens at the client;
    the server only decodes.  Raises if the upload carries more than
    ``max_k`` nonzeros (an oversized payload is rejected at the edge, not
    truncated).
    """
    flat = _flat_f32(payload)
    s = flat.numel()
    nz = torch.nonzero(flat, as_tuple=True)[0]  # -0.0 is not a nonzero
    k = int(nz.numel())
    if max_k is not None and k > max_k:
        raise ValueError(f"upload has {k} nonzero coords > max_k={max_k}")
    # one copy of the k coordinates and value bits to the host
    host = torch.cat([nz.to(torch.int32),
                      flat[nz].view(torch.int32)]).cpu().numpy()
    coords, vals = host[:k], host[k:].view(np.float32)
    b = float(b)
    quantized = b < 32.0 and step > 0.0
    if quantized:
        # recover the integer grid codes: vals = q * step with |q| small,
        # so the float64 divide rounds back to q exactly
        codes = np.rint(vals.astype(np.float64) / step).astype(np.int32)
    else:
        codes = vals.view(np.int32)
        step, b = 1.0, 32.0
    bits = k * (b + index_bits(s)) + (Q.SCALE_BITS if (quantized and k) else 0)
    return WirePayload(coords=coords, codes=codes, step=float(step), b=b,
                       k=k, device=int(device), rnd=int(rnd), ok=float(ok),
                       bits=float(bits))


def pack_batch(payloads: Sequence[WirePayload], *, s: int, max_k: int,
               batch: int, server_round: int = 0,
               out: Optional[dict] = None) -> dict:
    """Pad up to ``batch`` payloads onto static-shape numpy arrays for the
    fused ingest op.

    Pad coordinate is ``s`` (out of range: the scatter drops it); empty
    slots carry ``mask = 0`` and contribute exact zeros.  ``dtau`` is the
    server-side staleness ``server_round - payload.rnd`` (clipped at 0)
    that the ``alpha * s(delta_tau)`` mixing family consumes.  ``out``: the
    arrays to fill in place (the server's pinned staging buffer), keyed as
    ``PACKED_KEYS``; new arrays by default.
    """
    if len(payloads) > batch:
        raise ValueError(f"{len(payloads)} payloads > batch={batch}")
    if out is None:
        out = {k: np.empty((batch, max_k) if k in ("coords", "codes")
                           else (batch,),
                           np.int32 if k in ("coords", "codes")
                           else np.float32)
               for k in PACKED_KEYS}
    coords, codes = out["coords"], out["codes"]
    coords.fill(s)
    codes.fill(0)
    out["step"].fill(1.0)
    out["b"].fill(32.0)
    for k in ("dtau", "mask", "bits"):
        out[k].fill(0.0)
    for i, p in enumerate(payloads):
        if p.k > max_k:
            raise ValueError(f"payload k={p.k} > max_k={max_k}")
        coords[i, : p.k] = p.coords
        codes[i, : p.k] = p.codes
        out["step"][i] = p.step
        out["b"][i] = p.b
        out["dtau"][i] = max(server_round - p.rnd, 0)
        out["mask"][i] = p.ok
        out["bits"][i] = p.bits
    return out


def decode_values(codes, steps, bwidths) -> torch.Tensor:
    """Dequantise a packed ``(B, K)`` code block on its device.

    ``b < 32`` rows decode as ``codes * step``, the same single float32
    multiply the codecs' stochastic rounding performed (hence bit-equal to
    the dense payload); ``b == 32`` rows bitcast the raw float pattern
    back.
    """
    codes = torch.as_tensor(codes).to(torch.int32)
    steps = torch.as_tensor(steps).to(device=codes.device, dtype=torch.float32)
    bw = torch.as_tensor(bwidths).to(device=codes.device, dtype=torch.float32)
    grid = codes.to(torch.float32) * steps[:, None]
    return torch.where(bw[:, None] < 32.0, grid, codes.view(torch.float32))
