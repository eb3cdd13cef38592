"""Serving tier of the port: engine, host-loop engine, scheduler, paging,
sampling, ledger."""
from repro_torch.serve.engine import Engine, StepBudgetExceeded
from repro_torch.serve.host_loop import HostLoopEngine
from repro_torch.serve.scheduler import Request, Scheduler

__all__ = ["Engine", "HostLoopEngine", "Request", "Scheduler",
           "StepBudgetExceeded"]
