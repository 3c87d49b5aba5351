from repro_torch.mobility.contact import ContactProcess, intervals_to_rounds

__all__ = ["ContactProcess", "intervals_to_rounds"]
