"""Operational CLIs over the public ``repro_torch.api`` facade:
``python -m repro_torch.tools.plan`` and ``python -m
repro_torch.tools.trace``."""
