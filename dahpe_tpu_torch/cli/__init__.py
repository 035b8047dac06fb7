"""Command-line entry points: ``python -m dahpe_tpu_torch.cli.train`` and
``python -m dahpe_tpu_torch.cli.test``."""
