from repro_torch.mobility.contact import ContactProcess, intervals_to_rounds
from repro_torch.mobility.waypoint import RandomWaypoint, measure_contact_stats

__all__ = [
    "ContactProcess",
    "intervals_to_rounds",
    "RandomWaypoint",
    "measure_contact_stats",
]
