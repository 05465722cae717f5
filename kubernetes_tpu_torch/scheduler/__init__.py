"""Scheduler host layers the wave path needs: node aggregates, the cache and
its snapshot, the spread defaults, and the device backend."""
