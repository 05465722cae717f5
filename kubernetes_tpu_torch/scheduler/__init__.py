"""The scheduler: the store-driven Scheduler and its scheduling loop
(scheduler.py, schedule_one.py), the queue, node aggregates, the cache and
its snapshot, the framework and plugins, and the device backend (tpu/)."""
