"""Scheduler cluster cache: live state, snapshots, node ordering.

Reference: pkg/scheduler/backend/cache/.
"""

from .cache import Cache  # noqa: F401
from .node_tree import NodeTree  # noqa: F401
from .snapshot import Snapshot  # noqa: F401
