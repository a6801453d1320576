"""Run summaries (own copy of ``happysim_tpu/instrumentation/summary.py``):
what :meth:`EnsembleResult.summary <happysim_tpu_torch.engine.EnsembleResult.summary>`
returns, with the reference's fields, ``to_dict`` and text, so code that
reads a summary reads either package's.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

from happysim_tpu_torch.temporal import Instant


@dataclass(frozen=True)
class QueueStats:
    depth: int = 0
    enqueued: int = 0
    dequeued: int = 0
    dropped: int = 0


@dataclass(frozen=True)
class EntitySummary:
    name: str
    kind: str
    events_received: Optional[int] = None
    count: Optional[int] = None
    extra: dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> dict[str, Any]:
        out: dict[str, Any] = {"name": self.name, "kind": self.kind}
        if self.events_received is not None:
            out["events_received"] = self.events_received
        if self.count is not None:
            out["count"] = self.count
        out.update(self.extra)
        return out


@dataclass
class SimulationSummary:
    """What a run did: counts, timing, per-entity stats."""

    start_time: Instant
    end_time: Instant
    events_processed: int
    wall_clock_seconds: float
    entities: list[EntitySummary] = field(default_factory=list)
    completed: bool = True
    backend: str = "python"
    replicas: int = 1
    # Replicas whose event budget ran out before the horizon: non-zero
    # means the statistics lean toward early simulated time.
    truncated_replicas: int = 0

    @property
    def simulated_seconds(self) -> float:
        return (self.end_time - self.start_time).to_seconds()

    @property
    def events_per_second(self) -> float:
        if self.wall_clock_seconds <= 0:
            return 0.0
        return self.events_processed / self.wall_clock_seconds

    def to_dict(self) -> dict[str, Any]:
        return {
            "start_time_s": self.start_time.to_seconds(),
            "end_time_s": self.end_time.to_seconds(),
            "events_processed": self.events_processed,
            "wall_clock_seconds": self.wall_clock_seconds,
            "events_per_second": self.events_per_second,
            "completed": self.completed,
            "backend": self.backend,
            "replicas": self.replicas,
            "truncated_replicas": self.truncated_replicas,
            "entities": [e.to_dict() for e in self.entities],
        }

    def __str__(self) -> str:
        lines = [
            "SimulationSummary",
            f"  time: {self.start_time.to_seconds():.3f}s -> {self.end_time.to_seconds():.3f}s"
            f" ({'completed' if self.completed else 'paused'})",
            f"  events: {self.events_processed:,} in {self.wall_clock_seconds:.3f}s wall"
            f" ({self.events_per_second:,.0f} events/s, backend={self.backend}"
            + (f", replicas={self.replicas}" if self.replicas > 1 else "")
            + ")",
        ]
        if self.truncated_replicas:
            lines.append(
                f"  WARNING: {self.truncated_replicas} replicas hit the event"
                " budget before the horizon (stats biased early)"
            )
        for entity in self.entities:
            parts = [f"    {entity.name} [{entity.kind}]"]
            if entity.events_received is not None:
                parts.append(f"received={entity.events_received}")
            if entity.count is not None:
                parts.append(f"count={entity.count}")
            for key, value in entity.extra.items():
                parts.append(f"{key}={value}")
            lines.append(" ".join(parts))
        return "\n".join(lines)
