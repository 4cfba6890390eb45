"""Launchers: the serving and training CLIs (``python -m
repro_torch.launch.serve``, ``python -m repro_torch.launch.train``)."""
