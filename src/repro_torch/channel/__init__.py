from repro_torch.channel.wireless import (
    WirelessChannel,
    energy_joules,
    shannon_rate,
)

__all__ = ["WirelessChannel", "shannon_rate", "energy_joules"]
