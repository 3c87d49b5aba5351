"""The port's numpy side against the reference: exact array equality.

Data, partitions, loaders, the exponential contact schedule (with and
without speed coupling), channel gains, energy budgets and the FedMobile
relay rewrite are numpy code carried over with imports rewritten; the
same seeds must give the same arrays.
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.channel import WirelessChannel  # noqa: E402
from repro.configs import FLConfig  # noqa: E402
from repro.core import baselines as BL  # noqa: E402
from repro.core.runner import build_provider, sample_budgets  # noqa: E402
from repro.data import DeviceLoader, SyntheticCifar, dirichlet_partition  # noqa: E402
from repro_torch.channel import WirelessChannel as TWirelessChannel  # noqa: E402
from repro_torch.configs import FLConfig as TFLConfig  # noqa: E402
from repro_torch.core import baselines as TBL  # noqa: E402
from repro_torch.core.runner import build_provider as t_build_provider  # noqa: E402
from repro_torch.core.runner import sample_budgets as t_sample_budgets  # noqa: E402
from repro_torch.data import DeviceLoader as TDeviceLoader  # noqa: E402
from repro_torch.data import SyntheticCifar as TSyntheticCifar  # noqa: E402
from repro_torch.data import dirichlet_partition as t_dirichlet  # noqa: E402
from repro_torch.scenarios import ScenarioProvider  # noqa: E402


def _eq(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_fl_config_fields_match():
    ref = {f.name: f.default for f in dataclasses.fields(FLConfig)}
    port = {f.name: f.default for f in dataclasses.fields(TFLConfig)}
    assert ref == port


@pytest.mark.parametrize("seed", [0, 5])
def test_synthetic_cifar_and_partition(seed):
    ref, port = SyntheticCifar(seed=seed), TSyntheticCifar(seed=seed)
    _eq(ref.make_split(300, seed=seed + 1), port.make_split(300, seed=seed + 1))
    labels = ref.make_split(300, seed=seed + 1)[1]
    for rho in (0.1, 0.5, 10.0):
        _eq(dirichlet_partition(labels, 6, rho, seed),
            t_dirichlet(labels, 6, rho, seed))


def test_device_loader_sequences():
    rng = np.random.default_rng(2)
    dev = [{"images": rng.normal(size=(n, 2)).astype(np.float32),
            "labels": np.arange(n, dtype=np.int32)} for n in (9, 12, 17)]
    ref, port = DeviceLoader(dev, 4, 3), TDeviceLoader(dev, 4, 3)
    for _ in range(7):
        a, b = ref.sample_all(), port.sample_all()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_device_loader_refuses_short_shards():
    """A device with fewer samples than the batch would never yield a
    batch: the loader refuses it instead of looping forever."""
    dev = [{"labels": np.arange(n)} for n in (9, 3)]
    with pytest.raises(ValueError, match="device 1 holds 3 samples"):
        TDeviceLoader(dev, 4, 0)


@pytest.mark.parametrize("kw", [
    {},
    {"mean_intercontact": 20.0},
    {"speed": 12.0},
    {"speed": 3.0, "num_devices": 7, "seed": 4},
], ids=["paper", "short-gaps", "speed", "speed-7dev"])
@pytest.mark.parametrize("policy", ["mads", "fedmobile"])
def test_contact_schedule_and_gains(kw, policy):
    kw = {"num_devices": 5, **kw}
    fl, tfl = FLConfig(**kw), TFLConfig(**kw)
    ref = build_provider(fl, policy, None, 40, fl.seed).schedule()
    port = t_build_provider(tfl, policy, None, 40, tfl.seed).schedule()
    _eq(ref, port)
    assert [a.dtype for a in ref] == [a.dtype for a in port]
    np.testing.assert_array_equal(np.asarray(sample_budgets(fl, fl.seed)),
                                  t_sample_budgets(tfl, tfl.seed))


def test_array_schedule_and_channel():
    rng = np.random.default_rng(9)
    zeta = (rng.random((30, 4)) < 0.3).astype(np.int32)
    tau = rng.exponential(4.0, (30, 4)).astype(np.float32) * zeta
    fl, tfl = FLConfig(num_devices=4), TFLConfig(num_devices=4)
    _eq(build_provider(fl, "mads", (zeta, tau), 30, 3).schedule(),
        t_build_provider(tfl, "mads", (zeta, tau), 30, 3).schedule())
    _eq(BL.apply_relays(zeta, tau, seed=2), TBL.apply_relays(zeta, tau, seed=2))
    ref, port = WirelessChannel(seed=8), TWirelessChannel(seed=8)
    np.testing.assert_array_equal(ref.sample_gain((6, 5)), port.sample_gain((6, 5)))
    np.testing.assert_array_equal(ref.rate(0.2, 1e-9), port.rate(0.2, 1e-9))


def test_unknown_mobility_model_raises():
    for backend in ("numpy", "jax"):
        with pytest.raises(KeyError, match="unknown mobility model"):
            ScenarioProvider.from_config(
                TFLConfig(mobility_model="levy", scenario_backend=backend), 5,
                device="cpu")
