"""Deprecated constructors kept for source compatibility (the port of
repro.runtime.trainer).

The host-level WSP runtime lives behind the declarative experiment layer
(`repro_torch.api`): describe a scenario with a `Plan` and run it with
`Engine`.
`WSPTrainer` and `bsp_allreduce_baseline` survive only as thin shims that
build a Plan internally — new code should construct the Plan directly:

    from repro_torch.api import Plan, ClusterSpec, RunSpec, WSP, BSP, Engine

    report = Engine(Plan(arch=cfg,
                         cluster=ClusterSpec(num_vw=4, topology="hetero"),
                         sync=WSP(D=2, async_push=True),
                         run=RunSpec(max_waves=50))).fit()

Both take `device=` like Engine (None: the CUDA card).
"""
from __future__ import annotations

import warnings
from typing import Callable, Optional

from repro_torch.api.engine import Engine
from repro_torch.api.plan import ClusterSpec, Plan, RunSpec
from repro_torch.api.report import TrainReport                       # noqa: F401
from repro_torch.api.sync import BSP, WSP
from repro_torch.dist.topology import ClusterTopology


def _deprecated(old: str, new: str):
    warnings.warn(
        f"{old} is deprecated; build a repro_torch.api.Plan and use {new} "
        f"instead",
        DeprecationWarning, stacklevel=3)


class WSPTrainer:
    """Deprecated: shim over repro_torch.api.Engine with a WSP SyncPolicy."""

    def __init__(self, init_params, wave_step: Callable, optimizer, *,
                 num_vw: int, D: int = 0, batch: int = 8, seq: int = 64,
                 vocab: int = 256, max_waves: int = 20,
                 speeds: Optional[list] = None,
                 straggle_fns: Optional[list] = None,
                 compression_ratio: Optional[float] = None,
                 codec=None,
                 topology: ClusterTopology | str | None = None,
                 time_scale: float = 1.0,
                 ckpt_dir: Optional[str] = None, ckpt_every: int = 0,
                 fail_at: Optional[dict[int, int]] = None,
                 data_seed: int = 0, pull_every: int = 1,
                 async_push: bool = False, device=None):
        _deprecated("WSPTrainer", "Engine(plan).fit()")
        plan = Plan(
            cluster=ClusterSpec(num_vw=num_vw, topology=topology,
                                speeds=speeds, straggle_fns=straggle_fns,
                                fail_at=fail_at or {},
                                time_scale=time_scale),
            sync=WSP(D=D, pull_every=pull_every, async_push=async_push),
            run=RunSpec(max_waves=max_waves, batch=batch, seq=seq,
                        vocab=vocab, codec=codec,
                        compression_ratio=compression_ratio,
                        ckpt_dir=ckpt_dir, ckpt_every=ckpt_every,
                        data_seed=data_seed))
        self.engine = Engine(plan, params=init_params, wave_step=wave_step,
                             optimizer=optimizer, device=device)
        # eager build, matching the old constructor's observable surface
        self.engine._ensure_model()
        self.engine._ensure_ps(plan.sync)

    @property
    def ps(self):
        return self.engine.ps

    @property
    def workers(self):
        return self.engine.workers

    @property
    def topology(self):
        return self.engine.topology

    @property
    def stop_event(self):
        return self.engine.stop_event

    def run(self, *, rejoin_failed_after: Optional[float] = None
            ) -> TrainReport:
        return self.engine.fit(rejoin_failed_after=rejoin_failed_after)


def bsp_allreduce_baseline(init_params, wave_step, optimizer, *, num_vw: int,
                           batch: int, seq: int, vocab: int, max_waves: int,
                           speeds: Optional[list] = None,
                           topology: ClusterTopology | str | None = None,
                           data_seed: int = 0, device=None) -> TrainReport:
    """Deprecated: shim over repro_torch.api.Engine with the BSP SyncPolicy."""
    _deprecated("bsp_allreduce_baseline", "Engine(plan with sync=BSP()).fit()")
    plan = Plan(
        cluster=ClusterSpec(num_vw=num_vw, topology=topology, speeds=speeds),
        sync=BSP(),
        run=RunSpec(max_waves=max_waves, batch=batch, seq=seq, vocab=vocab,
                    data_seed=data_seed))
    return Engine(plan, params=init_params, wave_step=wave_step,
                  optimizer=optimizer, device=device).fit()
