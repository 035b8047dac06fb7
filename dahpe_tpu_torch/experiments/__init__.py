"""Acceptance experiments and drills (accuracy- and operations-level
evidence, not unit tests).

Port of ``dahpe_tpu/experiments/``: the adaptation acceptance
(``adaptation``), the content-shift calibration (``content_calibration``),
the published-checkpoint acceptance (``acceptance``), the soak and the
preemption drill through the training CLI (``soak``, ``preempt_drill``)
and the producer's stage-by-stage timing on the card (``perf_audit``)."""

from dahpe_tpu_torch.experiments.adaptation import run_adaptation_experiment

__all__ = ["run_adaptation_experiment"]
