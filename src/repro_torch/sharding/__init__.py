"""Declarative parameter specs, their initialisation and the logical-axis
sharding rules."""
from repro_torch.sharding.rules import (
    RULES_SERVE,
    RULES_TRAIN,
    ParamSpec,
    axes_tree,
    init_params,
    logical_to_pspec,
    prepend_axis,
    pspec_tree,
    shapes_tree,
    sharding_tree,
)

__all__ = [
    "RULES_SERVE",
    "RULES_TRAIN",
    "ParamSpec",
    "axes_tree",
    "init_params",
    "logical_to_pspec",
    "prepend_axis",
    "pspec_tree",
    "shapes_tree",
    "sharding_tree",
]
