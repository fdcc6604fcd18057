"""Entry points run as modules: ``python -m repro_torch.launch.train``."""
