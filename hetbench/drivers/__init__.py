"""Entry points a traffic mix names (`entry`): fit (Engine.fit on the
threads backend) and scheduler (Scheduler.run over the paged pool)."""
