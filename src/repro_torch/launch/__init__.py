"""Launchers of the torch package (``python -m repro_torch.launch.serve``)."""
