"""Exponential contact / inter-contact process (paper §III-B).

Each device alternates contact periods tau ~ Exp(mean c_n) and
inter-contact gaps t ~ Exp(mean lambda_n).  Rounds have duration delta;
zeta_n^(r) = 1 in the round where a contact event begins (one upload
opportunity per contact, with the full sampled contact duration tau
available for the transfer) — matching the paper's abstraction where
tau_n^(r) bounds the upload bits via tau * A.

With speed coupling (Lemma/Corollary setting): c = C / v, lambda = L / v.

``sample_rounds`` is fully vectorized (batched renewal sampling across
devices + a flat interval->round scatter); numpy, exactly the reference's.
"""
from __future__ import annotations

import dataclasses

import numpy as np


def intervals_to_rounds(dev, start, dur, num_devices: int, rounds: int,
                        delta: float):
    """Map contact intervals to per-round (zeta, tau), Algorithm-1 semantics.

    dev / start / dur: flat arrays of contact intervals, time-ordered within
    each device.  A device is in contact for every round its interval
    overlaps; tau is the full interval duration in the round where the
    contact begins and the remaining duration from the round boundary in
    continuation rounds.  When two intervals touch the same round (a gap
    shorter than delta), the earlier interval claims it — identical to the
    sequential loop's first-writer-wins rule.

    Returns (zeta, tau): (rounds, num_devices) int32 / float32.
    """
    zeta = np.zeros(rounds * num_devices, np.int32)
    tau = np.zeros(rounds * num_devices, np.float32)
    horizon = rounds * delta
    keep = (np.asarray(start) < horizon) & (np.asarray(dur) > 0)
    dev = np.asarray(dev)[keep]
    start = np.asarray(start, np.float64)[keep]
    dur = np.asarray(dur, np.float64)[keep]
    if len(dev) == 0:
        return (zeta.reshape(rounds, num_devices),
                tau.reshape(rounds, num_devices))

    end = start + dur
    r0 = (start / delta).astype(np.int64)
    # last covered round: ceil(end/delta) - 1, so a contact ending exactly on
    # a round boundary does not claim the next round with tau = 0 (discrete
    # traces hit boundaries constantly; the continuous model almost never)
    r1 = np.ceil(np.minimum(end, horizon - 1e-9) / delta).astype(np.int64) - 1
    r1 = np.minimum(np.maximum(r1, r0), rounds - 1)
    length = r1 - r0 + 1

    # expand each interval to its covered rounds (flat repeat + offset trick)
    iid = np.repeat(np.arange(len(length)), length)
    offs = np.arange(length.sum()) - np.repeat(np.cumsum(length) - length, length)
    rr = r0[iid] + offs
    tau_cand = np.where(offs == 0, dur[iid], end[iid] - rr * delta)
    flat = rr * num_devices + dev[iid]

    # first interval to reach a (round, device) cell wins: scatter in reverse
    # time order — duplicate fancy indices keep the LAST write, which after
    # reversal is the earliest interval (the sequential loop's rule)
    zeta[flat[::-1]] = 1
    tau[flat[::-1]] = tau_cand[::-1]
    return (zeta.reshape(rounds, num_devices),
            tau.reshape(rounds, num_devices))


@dataclasses.dataclass
class ContactProcess:
    num_devices: int
    mean_contact: float  # c_n
    mean_intercontact: float  # lambda_n
    round_duration: float  # delta
    seed: int = 0

    @classmethod
    def from_speed(cls, num_devices, speed, contact_const, intercontact_const,
                   round_duration, seed=0):
        v = max(speed, 1e-6)
        return cls(
            num_devices,
            mean_contact=contact_const / v,
            mean_intercontact=intercontact_const / v,
            round_duration=round_duration,
            seed=seed,
        )

    def sample_rounds(self, rounds: int):
        """Returns (zeta, tau): each (rounds, num_devices).

        Per Algorithm 1's zeta_n^(r): a device is "in contact in round r" for
        EVERY round its contact period overlaps.  tau[r, n] is the upload
        window available in that round: the full sampled contact duration in
        the round where the contact begins (the paper's tau ~ Exp(c)), and
        the remaining duration from the round boundary for continuation
        rounds of a long contact.

        Vectorized: all renewal cycles are drawn in one batch across devices,
        then contact intervals are scattered to rounds in one pass.
        """
        rng = np.random.default_rng(self.seed)
        n, delta = self.num_devices, self.round_duration
        horizon = rounds * delta
        c, lam = self.mean_contact, self.mean_intercontact

        # start in contact or in a gap, per renewal stationarity
        sic = rng.random(n) < c / (c + lam)
        m = max(4, int(horizon / (c + lam) * 1.6) + 4)
        while True:
            cdur = np.maximum(rng.exponential(c, (n, m)), 1e-9)
            gdur = np.maximum(rng.exponential(lam, (n, m)), 1e-9)
            dur = np.empty((n, 2 * m))
            dur[:, 0::2] = np.where(sic[:, None], cdur, gdur)
            dur[:, 1::2] = np.where(sic[:, None], gdur, cdur)
            if dur.sum(axis=1).min() >= horizon:
                break
            m *= 2  # rare: a device's cycles fell short of the horizon

        end = np.cumsum(dur, axis=1)
        start = end - dur
        is_contact = np.empty((n, 2 * m), bool)
        is_contact[:, 0::2] = sic[:, None]
        is_contact[:, 1::2] = ~sic[:, None]
        sel = is_contact & (start < horizon)
        dev = np.broadcast_to(np.arange(n)[:, None], sel.shape)[sel]
        return intervals_to_rounds(dev, start[sel], dur[sel], n, rounds, delta)
