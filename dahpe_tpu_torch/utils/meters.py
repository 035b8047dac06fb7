"""Host-side console metering (port of ``dahpe_tpu/utils/meters.py``):
running averages for losses and accuracies with the reference's display."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, Mapping


@dataclass
class AverageMeter:
    """Streaming weighted mean of a scalar, with a formatted one-line view.

    ``fmt`` is a ``str.format`` spec for the value, given with its leading
    colon (e.g. ``":4.2f"``).
    """

    name: str
    fmt: str = ":f"
    val: float = field(default=0.0, init=False)
    sum: float = field(default=0.0, init=False)
    count: int = field(default=0, init=False)

    def reset(self) -> None:
        self.val = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1) -> None:
        self.val = float(val)
        self.sum += self.val * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def __str__(self) -> str:
        spec = self.fmt.lstrip(":")
        return f"{self.name} {self.val:{spec}} ({self.avg:{spec}})"


class AverageMeterDict:
    """One :class:`AverageMeter` per key (e.g. per keypoint group)."""

    def __init__(self, names: Iterable[str], fmt: str = ":f"):
        self._meters: Dict[str, AverageMeter] = {
            name: AverageMeter(name, fmt) for name in names
        }

    def update(self, values: Mapping[str, float], n: int = 1) -> None:
        for name, value in values.items():
            self._meters[name].update(value, n)

    def average(self) -> Dict[str, float]:
        return {name: meter.avg for name, meter in self._meters.items()}

    def __getitem__(self, name: str) -> AverageMeter:
        return self._meters[name]
