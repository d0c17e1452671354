"""Synchronization policies — the strategy hierarchy behind Engine.fit()
(the port of repro.api.sync).

  WSP(D, pull_every, async_push)  wave synchronous parallel: threaded VWs
                                  against the sharded parameter server with
                                  the global staleness bound D (paper
                                  Sections 4-5)
  BSP()                           the AllReduce baseline: every wave all
                                  deltas are ring-all-reduced and applied to
                                  one global copy
  ASP(...)                        asynchronous parallel = WSP with an
                                  unbounded clock distance

A policy is declarative configuration plus a single `execute(engine)`
dispatch; the execution loops live in `repro_torch.api.engine`.
"""
from __future__ import annotations

from dataclasses import dataclass

# "D = infinity" as an int the WSP clock machine can compare against
UNBOUNDED_D = 1 << 30


@dataclass(frozen=True)
class SyncPolicy:
    """Base class: every policy validates itself."""

    @property
    def kind(self) -> str:
        return type(self).__name__.lower()

    def validate(self) -> None:
        pass

    def execute(self, engine, **kw):
        raise NotImplementedError

    def describe(self) -> str:
        return self.kind


@dataclass(frozen=True)
class WSP(SyncPolicy):
    D: int = 0                  # global clock-distance bound (0 = lock step)
    pull_every: int = 1         # pull w_global every k waves
    async_push: bool = False    # overlap the wave push with the next compute

    def validate(self) -> None:
        if not isinstance(self.D, int) or self.D < 0:
            raise ValueError(f"WSP staleness bound D must be an int >= 0, "
                             f"got {self.D!r}")
        if self.pull_every < 1:
            raise ValueError(f"pull_every must be >= 1, got {self.pull_every}")

    def execute(self, engine, **kw):
        return engine._fit_threaded(self, **kw)

    def describe(self) -> str:
        d = "inf" if self.D >= UNBOUNDED_D else self.D
        return (f"WSP(D={d}, pull_every={self.pull_every}, "
                f"async_push={self.async_push})")


@dataclass(frozen=True)
class ASP(WSP):
    """Fully asynchronous parallel: WSP with the staleness gate disabled."""
    D: int = UNBOUNDED_D


@dataclass(frozen=True)
class BSP(SyncPolicy):
    """Synchronous AllReduce data parallelism (the paper's baseline). Wall
    clock is simulated straggler-gated time: each wave costs the max over
    VWs of (compute + slowdown) plus the modeled all-reduce."""
    average: bool = True        # mean the deltas (each VW sees 1/N of batch)

    def execute(self, engine, **kw):
        return engine._fit_bsp(self, **kw)
