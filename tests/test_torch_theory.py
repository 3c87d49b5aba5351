"""The port's closed-form theory against the reference's: equal values.

``repro_torch/core/theory.py`` is the reference's numpy module carried
over, so every function must return exactly (``==``) what the
reference's returns: on the operating points of ``tests/test_theory.py``
and on a grid drawn from a numpy seed.
"""
import numpy as np
import pytest

from repro.core import theory as R
from repro_torch.core import theory as T

S_RESNET9 = 6_568_650  # tests/test_theory.py's model size
STD = dict(f0_gap=1.0, big_l=1.0, sigma=1.0, g2=1.0)


def _grid(seed: int, n: int = 24):
    """(rate, c, lam, delta, s, u) operating points from a numpy seed."""
    rng = np.random.default_rng(seed)
    return [dict(rate=float(10 ** rng.uniform(3, 7)),
                 c=float(rng.uniform(0.5, 64.0)),
                 lam=float(rng.uniform(5.0, 2000.0)),
                 delta=float(rng.uniform(1.0, 20.0)),
                 s=int(rng.integers(2, 10_000_000)),
                 u=int(rng.choice([8, 16, 32])))
            for _ in range(n)]


def _cases(name: str) -> list:
    """(args, kwargs) cases for one theory function."""
    grid = _grid({"staleness_second_moment": 1, "gamma": 2,
                  "gamma_model": 3, "expected_error_fraction": 4,
                  "sparsification_error_factor": 5,
                  "local_memory_bound": 6, "theorem1_rhs": 7,
                  "theorem2_rhs": 8, "corollary1_bound": 9,
                  "optimal_speed": 10}[name])
    if name == "staleness_second_moment":
        pts = [(c, lam, 10.0) for c, lam in
               [(4.0, 40.0), (8.0, 100.0), (2.0, 20.0)]]
        pts += [(4.0, lam, 10.0) for lam in (20, 80, 320)]
        pts += [(c, 100.0, 10.0) for c in (1.0, 8.0, 64.0)]
        pts += [(g["c"], g["lam"], g["delta"]) for g in grid]
        return [(p, {}) for p in pts]
    if name in ("gamma", "gamma_model", "sparsification_error_factor"):
        pts = [(1e6, 2.0, S_RESNET9), (1e6, 8.0, S_RESNET9),
               (4e6, 8.0, S_RESNET9), (2e4, 3.0, 4096)]
        return ([(p, {}) for p in pts]
                + [((g["rate"], g["c"], g["s"], g["u"]), {}) for g in grid])
    if name == "expected_error_fraction":
        return ([((2e4, 3.0, 4096, 32), {})]
                + [((g["rate"], g["c"], g["s"], g["u"]),
                    {"mc": 2000, "seed": i}) for i, g in enumerate(grid)])
    if name == "local_memory_bound":
        return [((g["rate"], g["c"], g["lam"], g["delta"], g["s"], 0.01, 2.0,
                  g["u"]), {}) for g in grid]
    if name == "theorem1_rhs":
        rng = np.random.default_rng(17)
        out = []
        for r, n in ((5, 4), (40, 20), (200, 8)):
            zeta = rng.integers(0, 2, (r, n)).astype(np.float64)
            theta = rng.integers(1, 30, (r, n)).astype(np.float64)
            s = int(rng.integers(1000, 7_000_000))
            k = rng.uniform(0, s, (r, n)) * zeta
            x2 = rng.exponential(1.0, (r, n))
            out.append(((1.0, 0.05, 1.0, 1.0, 1.0, n, r, zeta, theta, k, x2,
                         s), {}))
        return out
    if name == "theorem2_rhs":
        common = dict(n=20, rounds=500, **STD)
        pts = [dict(rate=1e6, c=c, lam=400.0, delta=10.0, s=S_RESNET9,
                    **common) for c in (1.0, 4.0, 16.0)]
        pts += [dict(rate=1e6, c=4.0, lam=lam, delta=10.0, s=S_RESNET9,
                     **common) for lam in (100.0, 400.0, 1600.0)]
        pts += [dict(rate=g["rate"], c=g["c"], lam=g["lam"],
                     delta=g["delta"], s=g["s"], u=g["u"], **common)
                for g in grid]
        return [((), p) for p in pts]
    if name == "corollary1_bound":
        model = dict(n=20, rounds=500, rate=1e6, contact_const=200.0,
                     intercontact_const=4000.0, delta=10.0, s=100_000,
                     gamma_mode="model", **STD)
        paper = dict(n=20, rounds=500, rate=1e6, contact_const=40.0,
                     intercontact_const=4000.0, delta=10.0, s=S_RESNET9,
                     **STD)
        out = [((v,), model) for v in np.linspace(1.0, 120, 240)]
        out += [((v,), paper) for v in (2.0, 30.0)]
        out += [((float(v),), dict(paper, s=g["s"], u=g["u"],
                                   rate=g["rate"], gamma_mode=mode))
                for g, v, mode in zip(grid, np.linspace(0.5, 60, len(grid)),
                                      ["paper", "model"] * len(grid))]
        return out
    if name == "optimal_speed":
        args = dict(n=20, rounds=500, rate=1e6, contact_const=200.0,
                    intercontact_const=4000.0, delta=10.0, s=100_000,
                    gamma_mode="model", **STD)
        return [((args,), {}), ((args,), {"v_grid": np.linspace(1, 120, 240)}),
                ((dict(args, gamma_mode="paper", s=S_RESNET9),), {})]
    raise KeyError(name)


FUNCTIONS = ["staleness_second_moment", "gamma", "gamma_model",
             "expected_error_fraction", "sparsification_error_factor",
             "local_memory_bound", "theorem1_rhs", "theorem2_rhs",
             "corollary1_bound", "optimal_speed"]


def test_every_public_function_is_covered():
    public = sorted(n for n in dir(R) if callable(getattr(R, n))
                    and not n.startswith("_")
                    and getattr(getattr(R, n), "__module__", "") == R.__name__)
    assert public == sorted(FUNCTIONS)
    assert all(callable(getattr(T, n)) for n in FUNCTIONS)


@pytest.mark.parametrize("name", FUNCTIONS)
def test_theory_equals_reference(name):
    """Bit-equal values (``==``; same numpy, same operations) on every
    case, and finite wherever the reference's are."""
    ref, port = getattr(R, name), getattr(T, name)
    cases = _cases(name)
    assert len(cases) >= 3
    for args, kw in cases:
        a, b = ref(*args, **kw), port(*args, **kw)
        assert type(a) is type(b), (name, args, kw)
        assert a == b or (np.isnan(a) and np.isnan(b)), (name, args, kw, a, b)


def test_port_reproduces_the_papers_shapes():
    """The remarks ``tests/test_theory.py`` checks, on the port's module:
    Theta rises with lambda and falls with c, gamma rises with c and A,
    Corollary 1 (model gamma) is U-shaped with an interior optimum."""
    vals = [T.staleness_second_moment(4.0, lam, 10.0) for lam in (20, 80, 320)]
    assert vals[0] <= vals[1] <= vals[2]
    vals = [T.staleness_second_moment(c, 100.0, 10.0) for c in (1.0, 8.0, 64.0)]
    assert vals[0] >= vals[1] >= vals[2]
    assert (T.gamma(1e6, 2.0, S_RESNET9) <= T.gamma(1e6, 8.0, S_RESNET9)
            <= T.gamma(4e6, 8.0, S_RESNET9) <= 1.0)
    args = dict(n=20, rounds=500, rate=1e6, contact_const=200.0,
                intercontact_const=4000.0, delta=10.0, s=100_000,
                gamma_mode="model", **STD)
    v_grid = np.linspace(1.0, 120, 240)
    vals = np.array([T.corollary1_bound(v, **args) for v in v_grid])
    assert vals[0] > vals.min() * 1.05 and vals[-1] > vals.min() * 1.05
    assert 1.0 < T.optimal_speed(args, v_grid) < 120


def test_speed_sweep_example_matches_reference_columns():
    """The sweep twin (``repro_torch.examples.mobility_speed_sweep``) on the
    CPU, one round a point: its contact statistics and Corollary-1 bound
    are the reference example's (the same numpy trace and formula), and
    each run trains."""
    import math

    from repro.configs import FLConfig
    from repro.mobility.waypoint import measure_contact_stats
    from repro.scenarios import model_from_config
    from repro_torch.examples import mobility_speed_sweep as S

    torch = pytest.importorskip("torch")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        rows = S.main(["--models", "exponential,manhattan", "--rounds", "1",
                       "--device", "cpu"])
    finally:
        torch.set_num_threads(n)
    assert [(r["model"], r["speed"]) for r in rows] == \
        [(m, v) for m in ("exponential", "manhattan") for v in S.SPEEDS]
    for r in rows:
        v = r["speed"]
        fl = FLConfig(num_devices=8, rounds=1, batch_size=16,
                      learning_rate=0.02, speed=v, contact_const=S.C_CONST,
                      intercontact_const=S.L_CONST,
                      energy_budget=(40.0, 80.0), mobility_model=r["model"],
                      area=600.0)
        if r["model"] == "exponential":
            want = (S.C_CONST / v, S.L_CONST / v)
        else:
            trace = model_from_config(fl).trace(4000.0, fl.mobility_dt)
            want = measure_contact_stats(trace.in_range(fl.comm_range),
                                         fl.mobility_dt)
        assert (r["contact"], r["intercontact"]) == want
        assert r["bound"] == R.corollary1_bound(
            v, f0_gap=1.0, big_l=1.0, sigma=1.0, g2=1.0, n=8, rounds=1,
            rate=1e6, contact_const=S.C_CONST, intercontact_const=S.L_CONST,
            delta=10.0, s=103_954, gamma_mode="model")
        assert math.isfinite(r["acc"]) and r["uploads"] >= 0
