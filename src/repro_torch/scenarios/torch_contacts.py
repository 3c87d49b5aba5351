"""Device-resident contact extraction: in-range runs -> intervals -> (zeta, tau).

The torch twin of the reference's ``scenarios/jax_contacts.py``: the
device-resident counterpart of ``scenarios/contacts.py`` +
``mobility.contact.intervals_to_rounds``.  On the SAME (steps, N) in-range
matrix it is exactly equal to the numpy pair: the same first-writer-wins
round claiming, the same tau semantics (full contact duration at the
contact-start round, remaining duration from the round boundary in
continuation rounds) and the same end-of-trace censoring.

The extraction is scatter-free and shape-static, built from three
O(steps x N) prefix scans:

* ``start_idx[t]`` — running cummax of start-flag positions: the start
  step of the contact run covering t;
* ``end_idx[t]``   — reversed cummin of out-of-range positions: the
  first out-of-range step at/after t (``steps`` when the run reaches the
  trace end — the censored/truncated case);
* ``nxt[t]``       — reversed cummin of in-range positions: the first
  in-range step at/after t.

A round r spans step indices [t_lo, t_hi]; the earliest interval
overlapping it is the run of ``nxt[t_lo]``, and one gather per (round,
device) cell yields zeta/tau.  ``rounds_from_in_range`` never waits for
the device: no ``nonzero``, no host copies, and its per-round step
windows are computed on the device in float64 with the oracle's own
operations, so they equal the oracle's numpy tables.
"""
from __future__ import annotations

import torch

__all__ = ["contact_intervals_torch", "round_windows", "rounds_from_in_range",
           "run_bounds"]


def _prev(ir: torch.Tensor) -> torch.Tensor:
    """ir shifted one step down, with an out-of-range first row."""
    return torch.cat([torch.zeros_like(ir[:1]), ir[:-1]])


def run_bounds(in_range: torch.Tensor):
    """(start_idx, end_idx, nxt) int32 prefix-scan tables for a (steps, N)
    bool in-range matrix; see the module docstring for their semantics.
    ``steps`` is the sentinel."""
    ir = in_range
    steps = ir.shape[0]
    idx = torch.arange(steps, dtype=torch.int32, device=ir.device)[:, None]
    start_flag = ir & ~_prev(ir)
    start_idx = torch.cummax(torch.where(start_flag, idx, -1), dim=0).values

    def rev(x):
        return torch.flip(torch.cummin(torch.flip(x, [0]), dim=0).values, [0])

    end_idx = rev(torch.where(~ir, idx, steps))
    nxt = rev(torch.where(ir, idx, steps))
    return start_idx, end_idx, nxt


def contact_intervals_torch(in_range, dt: float, size=None):
    """Flat (dev, start, dur) contact intervals — the device-resident twin of
    ``scenarios.contacts.contact_intervals``, same device-then-time order.

    Contacts still open at the trace end are censored at the window,
    exactly like the oracle.  Without ``size`` the call waits for the
    device (a data-dependent result count); with a static ``size`` it does
    not, and the result is padded with -1 device ids beyond the true
    interval count (and cut at ``size``).
    """
    ir = torch.as_tensor(in_range).to(torch.bool)
    steps, n = ir.shape
    _, end_idx, _ = run_bounds(ir)
    start_flag = (ir & ~_prev(ir)).T.reshape(-1)  # (n*steps): device-major
    if size is None:
        flat = torch.nonzero(start_flag).reshape(-1)
    else:
        # slot of each start in the compacted list; starts past ``size``
        # and non-starts all land in one extra slot that is cut off
        slot = torch.cumsum(start_flag, 0) - 1
        slot = torch.where(start_flag & (slot < size), slot, size)
        flat = torch.full((size + 1,), -1, dtype=torch.int64, device=ir.device)
        flat.scatter_(0, slot, torch.arange(n * steps, device=ir.device))
        flat = flat[:size]
    dev = torch.div(flat, steps, rounding_mode="floor")
    t = torch.remainder(flat, steps)
    ok = flat >= 0
    e = end_idx[t, dev.clamp(min=0)].to(torch.int64)
    return (torch.where(ok, dev, -1),
            torch.where(ok, t, 0).to(torch.float32) * dt,
            torch.where(ok, (e - t).to(torch.float32) * dt, 0.0))


def round_windows(steps: int, dt: float, rounds: int, delta: float, device):
    """(t_lo, t_hi, in_window): round r covers steps [t_lo, t_hi]; rounds
    that start at or past the horizon (non-integer delta/dt grids) are out
    of the window.  float64 on the device, with the oracle's operations
    (floor(r delta / dt), ceil((r + 1) delta / dt) - 1), so no host table
    crosses to the device."""
    r = torch.arange(rounds, dtype=torch.float64, device=device)
    t_lo = torch.floor(r * delta / dt).to(torch.int64)
    t_hi = torch.clamp(
        torch.ceil((r + 1) * delta / dt).to(torch.int64) - 1, max=steps - 1)
    return t_lo.clamp(max=steps - 1), t_hi, t_lo < steps


def rounds_from_in_range(in_range, dt: float, rounds: int, delta: float,
                         drop_truncated: bool = False):
    """(zeta, tau) per round from a (steps, N) in-range matrix, exactly
    matching ``contact_intervals`` + ``intervals_to_rounds`` cell-wise.

    Returns ((rounds, N) int32, (rounds, N) float32) on the matrix's
    device.  ``drop_truncated`` zeroes every cell claimed by a contact
    still open at the trace end (a censored contact's tau under-states
    the real window), the extractor-level mirror of
    ``measure_contact_stats``'s ``drop_truncated``.
    """
    ir = torch.as_tensor(in_range).to(torch.bool)
    steps, n = ir.shape
    start_idx, end_idx, nxt = run_bounds(ir)

    # A run [S, E) overlaps round r iff S <= t_hi and E - 1 >= t_lo, and
    # two intersecting contiguous index ranges always share a step, so the
    # earliest overlapping run is the run of the first in-range step in
    # the window: nxt[t_lo].
    t_lo, t_hi, in_window = round_windows(steps, dt, rounds, delta, ir.device)
    tstar = nxt[t_lo]  # (rounds, n): first in-range step in the window
    valid = (tstar <= t_hi[:, None]) & in_window[:, None]
    tc = tstar.clamp(0, steps - 1).to(torch.int64)
    s_idx = torch.gather(start_idx, 0, tc)
    e_idx = torch.gather(end_idx, 0, tc)
    truncated = e_idx == steps  # run reaches the trace end (censored)

    s = s_idx.to(torch.float32) * dt
    e = e_idx.to(torch.float32) * dt
    r0 = torch.floor(s / delta).to(torch.int32)
    rr = torch.arange(rounds, dtype=torch.int32, device=ir.device)[:, None]
    tau_cand = torch.where(r0 == rr, e - s, e - rr.to(torch.float32) * delta)

    if drop_truncated:
        valid = valid & ~truncated
    zeta = valid.to(torch.int32)
    tau = torch.where(valid, tau_cand, 0.0).to(torch.float32)
    return zeta, tau
