from repro_torch.data.loader import DeviceLoader, batch_iterator
from repro_torch.data.partition import dirichlet_partition, gamma_class_proportions
from repro_torch.data.synthetic import (SyntheticCifar, SyntheticTokens,
                                        SyntheticTrajectories)

__all__ = [
    "DeviceLoader",
    "SyntheticCifar",
    "SyntheticTokens",
    "SyntheticTrajectories",
    "batch_iterator",
    "dirichlet_partition",
    "gamma_class_proportions",
]
