"""Runnable examples of the port, twins of the reference's ``examples/``.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
    PYTHONPATH=src python -m repro_torch.examples.mobility_speed_sweep \
        --models exponential,manhattan [--rounds 30] [--device cpu]
    PYTHONPATH=src python -m repro_torch.examples.cifar_mads_vs_baselines \
        [--rounds 40] [--device cpu]
"""
