"""Acceptance experiments (accuracy-level evidence, not unit tests).

Port of ``dahpe_tpu/experiments/``: so far the adaptation experiment."""

from dahpe_tpu_torch.experiments.adaptation import run_adaptation_experiment

__all__ = ["run_adaptation_experiment"]
