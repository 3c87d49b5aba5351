from repro_torch.scenarios.channel import gains_along_trace
from repro_torch.scenarios.contacts import contact_intervals, rounds_from_trace
from repro_torch.scenarios.heterogeneity import HeterogeneityModel, gate_windows
from repro_torch.scenarios.kinematics import (
    GaussMarkovModel,
    HotspotClusterModel,
    ManhattanGridModel,
    MobilityModel,
    RandomWaypointModel,
    Trace,
)
from repro_torch.scenarios.provider import (
    MODELS,
    ScenarioProvider,
    model_from_config,
    torch_model_from_config,
)
from repro_torch.scenarios.torch_contacts import (
    contact_intervals_torch,
    rounds_from_in_range,
)
from repro_torch.scenarios.torch_kinematics import (
    TORCH_MODELS,
    TorchGaussMarkovModel,
    TorchHotspotClusterModel,
    TorchManhattanGridModel,
    TorchRandomWaypointModel,
    TorchTrace,
    torch_gains_along_trace,
    torch_schedule_from_model,
)

__all__ = [
    "GaussMarkovModel",
    "HotspotClusterModel",
    "ManhattanGridModel",
    "MobilityModel",
    "RandomWaypointModel",
    "Trace",
    "TORCH_MODELS",
    "TorchGaussMarkovModel",
    "TorchHotspotClusterModel",
    "TorchManhattanGridModel",
    "TorchRandomWaypointModel",
    "TorchTrace",
    "HeterogeneityModel",
    "MODELS",
    "ScenarioProvider",
    "model_from_config",
    "torch_model_from_config",
    "contact_intervals",
    "contact_intervals_torch",
    "rounds_from_trace",
    "rounds_from_in_range",
    "gains_along_trace",
    "torch_gains_along_trace",
    "torch_schedule_from_model",
    "gate_windows",
]
