"""Command-line launchers of the port: ``python -m repro_torch.launch.bfs``
and ``python -m repro_torch.launch.analytics``."""
