from repro_torch.scenarios.provider import ScenarioProvider

__all__ = ["ScenarioProvider"]
