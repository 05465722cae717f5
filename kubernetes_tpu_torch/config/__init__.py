"""Scheduler configuration (reference: pkg/scheduler/apis/config/)."""

from .types import (
    LeaderElectionConfig,
    PluginSet,
    ProfileConfig,
    SchedulerConfiguration,
    load_config,
    load_config_file,
)

__all__ = [
    "LeaderElectionConfig", "PluginSet", "ProfileConfig",
    "SchedulerConfiguration", "load_config", "load_config_file",
]
