"""The port's analytic calculator and H100 roofline against the JAX
reference: ``fwd_flops_per_token``, ``encoder_flops``, ``step_analytics``
(worlds 1, 4, 256 and 512; ``model_parallel`` 0 and 1), ``active_params``
and ``model_flops`` exactly equal for every assigned architecture at every
input shape; the roofline's H100 constants, terms and collective count.
"""
import ast
import dataclasses
import math
import pathlib

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.configs import ASSIGNED_ARCHS, INPUT_SHAPES, get_config  # noqa: E402
from repro.launch import calculator as RC  # noqa: E402
from repro.launch import roofline as RRL  # noqa: E402
from repro.launch.steps import resolve_cfg  # noqa: E402
from repro.models.registry import build_model  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.core.distributed import CHUNK  # noqa: E402
from repro_torch.launch import calculator as TCalc  # noqa: E402
from repro_torch.launch import dryrun as TDR  # noqa: E402
from repro_torch.launch import roofline as TRL  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.models.registry import build_model as t_build_model  # noqa: E402

WORLDS = (1, 4, 256, 512)


def _reference_active_params():
    """``src/repro/launch/dryrun.py::active_params``, compiled from its
    source alone: importing the module would set ``XLA_FLAGS`` (512 host
    devices) for this process."""
    path = pathlib.Path(RC.__file__).with_name("dryrun.py")
    tree = ast.parse(path.read_text())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == "active_params")
    ns = {}
    exec(compile(ast.Module(body=[fn], type_ignores=[]), str(path), "exec"), ns)
    return ns["active_params"]


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_calculator_equals_reference(arch):
    for shape in INPUT_SHAPES:
        sh, tsh = INPUT_SHAPES[shape], TC.INPUT_SHAPES[shape]
        cfg = resolve_cfg(get_config(arch), sh)
        tcfg = TS.resolve_cfg(TC.get_config(arch), tsh)
        for ctx in (1, 4096 / 2, sh.seq_len, sh.seq_len / 2):
            for decode in (False, True):
                assert (TCalc.fwd_flops_per_token(tcfg, ctx, decode)
                        == RC.fwd_flops_per_token(cfg, ctx, decode))
        assert TCalc.encoder_flops(tcfg) == RC.encoder_flops(cfg)
        n = build_model(cfg).num_params()
        assert t_build_model(tcfg).num_params() == n
        for world in WORLDS:
            for mp in (0, 1):
                got = TCalc.step_analytics(tcfg, tsh, world, n, model_parallel=mp)
                want = RC.step_analytics(cfg, sh, world, n, model_parallel=mp)
                assert dataclasses.asdict(got) == dataclasses.asdict(want), (
                    shape, world, mp)


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_active_params_and_model_flops_equal_reference(arch):
    cfg, tcfg = get_config(arch), TC.get_config(arch)
    model, tmodel = build_model(cfg), t_build_model(tcfg)
    act = TDR.active_params(tcfg, tmodel)
    assert act == _reference_active_params()(cfg, model)
    for shape, sh in INPUT_SHAPES.items():
        tokens = sh.global_batch * (sh.seq_len if sh.kind != "decode" else 1)
        for train in (False, True):
            assert (TRL.model_flops(tmodel.num_params(), tokens, act, train)
                    == RRL.model_flops(model.num_params(), tokens, act, train))


def test_h100_constants():
    assert (TRL.PEAK_FLOPS, TRL.HBM_BW, TRL.LINK_BW) == (989e12, 3.35e12, 450e9)
    assert TRL.CARD_BYTES == 80e9


def test_analyze_terms_and_bottleneck():
    a = TCalc.Analytic(flops_total=8e12, flops_per_device=2e12,
                       hbm_bytes_per_device=1e9, tokens=10)
    coll = TRL.step_collectives("train", 1_000_000_000, 4)
    roof = TRL.analyze(a, coll, model_flops_total=4e12)
    assert roof.t_compute == 2e12 / 989e12
    assert roof.t_memory == 1e9 / 3.35e12
    assert roof.coll_bytes == 2 * 3 / 4 * 4e9 + 3 / 4 * 10 * 4 * 4
    assert roof.t_collective == roof.coll_bytes / 450e9
    assert roof.bottleneck == "collective"
    assert roof.bound_s == roof.t_collective
    assert roof.useful_ratio == 0.5
    assert roof.as_dict()["bound_s"] == roof.bound_s
    assert "hlo_flops_raw" not in roof.as_dict()


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_step_collectives(kind):
    """World 1 and serve steps move nothing; a train step over P ranks one
    all-reduce a column block of the aggregation in its upload dtype and
    one all-gather of the metrics."""
    s = 3 * CHUNK + 5
    assert TRL.step_collectives(kind, s, 1).total_bytes == 0.0
    got = TRL.step_collectives(kind, s, 8, 8, "bfloat16")
    if kind != "train":
        assert got.total_bytes == 0.0 and got.count_by_kind == {}
        return
    assert got.count_by_kind == {"all-reduce": 4, "all-gather": 1}
    assert got.bytes_by_kind["all-reduce"] == 2 * 7 / 8 * s * 2
    assert got.bytes_by_kind["all-gather"] == 7 / 8 * 10 * 8 * 4
    assert math.isclose(got.total_bytes, sum(got.bytes_by_kind.values()))
