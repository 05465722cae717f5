"""Scheduler cluster cache: live state, snapshots, node ordering, gang
member accounting.

Reference: pkg/scheduler/backend/cache/.
"""

from .cache import Cache  # noqa: F401
from .node_tree import NodeTree  # noqa: F401
from .podgroup_state import PodGroupState, PodGroupStates  # noqa: F401
from .snapshot import Placement, Snapshot  # noqa: F401
