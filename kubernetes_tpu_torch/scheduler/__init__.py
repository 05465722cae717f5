"""The scheduler: the store-driven Scheduler and its scheduling loop
(scheduler.py, schedule_one.py), the queue, node aggregates, the cache and
its snapshot, the framework and plugins, and the device backend (tpu/)."""


def __getattr__(name: str):
    # `from kubernetes_tpu_torch.scheduler import Scheduler`, as the
    # reference package exports it, without importing the whole scheduler
    # whenever one of its submodules is imported
    if name in ("Scheduler", "Profile", "Handle"):
        from . import scheduler

        return getattr(scheduler, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
