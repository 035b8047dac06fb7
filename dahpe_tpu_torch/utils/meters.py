"""Host-side console metering (port of ``dahpe_tpu/utils/meters.py``):
running averages for losses and accuracies with the reference's display."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, Mapping, Sequence


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


class ProgressMeter:
    """Tab-joined ``prefix[ i/N]  meter  meter ...`` progress line."""

    def __init__(self, num_batches: int, meters: Sequence[AverageMeter], prefix: str = ""):
        self.num_batches = num_batches
        self.meters = list(meters)
        self.prefix = prefix

    def display(self, batch: int) -> None:
        width = len(str(self.num_batches))
        counter = f"[{batch:{width}d}/{self.num_batches:{width}d}]"
        print("\t".join([self.prefix + counter, *map(str, self.meters)]), flush=True)
