"""Launchers: the serving CLI (``python -m repro_torch.launch.serve``)."""
