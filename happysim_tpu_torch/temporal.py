"""Integer-nanosecond simulation time (own copy of the part of
``happysim_tpu/core/temporal.py`` that :mod:`~happysim_tpu_torch.summary`
and :mod:`~happysim_tpu_torch.data` use).

An :class:`Instant` is a point on the timeline and a :class:`Duration` a
span, each one Python ``int`` of nanoseconds. Seconds become nanoseconds
by ``round(seconds * 1e9)``, as in the reference, so a summary's
``simulated_seconds`` and a series' sample times come out the same bits
in either package. The reference's arithmetic beyond the span between
two instants is left out: nothing here uses it.
"""

from __future__ import annotations

from typing import Union

NANOS_PER_SECOND = 1_000_000_000


def _seconds_to_nanos(seconds: Union[int, float]) -> int:
    return round(seconds * NANOS_PER_SECOND)


class Duration:
    """A signed span of time with nanosecond resolution."""

    __slots__ = ("nanoseconds",)

    def __init__(self, nanoseconds: int):
        self.nanoseconds = int(nanoseconds)

    def to_seconds(self) -> float:
        return self.nanoseconds / NANOS_PER_SECOND

    def __eq__(self, other: object) -> bool:
        if isinstance(other, Duration):
            return self.nanoseconds == other.nanoseconds
        return NotImplemented

    def __hash__(self) -> int:
        return hash(("Duration", self.nanoseconds))

    def __repr__(self) -> str:
        return f"Duration({self.to_seconds():.9g}s)"


class Instant:
    """A point on the simulation timeline (nanoseconds since the epoch)."""

    __slots__ = ("nanoseconds",)

    Epoch: "Instant"

    def __init__(self, nanoseconds: int):
        self.nanoseconds = int(nanoseconds)

    @classmethod
    def from_seconds(cls, seconds: Union[int, float]) -> "Instant":
        return cls(_seconds_to_nanos(seconds))

    def to_seconds(self) -> float:
        return self.nanoseconds / NANOS_PER_SECOND

    def __sub__(self, other: "Instant") -> Duration:
        if isinstance(other, Instant):
            return Duration(self.nanoseconds - other.nanoseconds)
        return NotImplemented

    def __eq__(self, other: object) -> bool:
        if isinstance(other, Instant):
            return self.nanoseconds == other.nanoseconds
        return NotImplemented

    def __hash__(self) -> int:
        return hash(("Instant", self.nanoseconds))

    def __repr__(self) -> str:
        return f"Instant({self.to_seconds():.9g}s)"


Instant.Epoch = Instant(0)


def as_instant(value: Union[Instant, int, float]) -> Instant:
    """Seconds or an Instant, as an Instant."""
    if isinstance(value, Instant):
        return value
    return Instant.from_seconds(value)
