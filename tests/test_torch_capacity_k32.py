"""The B4 configuration at 20 topology keys (K 32, the traffic's
constraints and terms on key slots 16-19) under the 21-point
RequestedToCapacityRatio profile over ten scored resources: K2's dedup
tier, the backend on both contexts (one program of the reference's for
both) and K4 through schedule_pod, the port's plain versions against the
JAX package, every output equal (tests/test_torch_capacity.py's cases)."""

from tests.test_torch_capacity import (  # noqa: F401 (fixtures)
    _case_backend_waves,
    _case_batched_assign,
    _case_schedule_pod,
    _own_process_state,
    _port_registry,
    waves,
)


def test_batched_assign_matches_reference(waves):
    _case_batched_assign(waves, "k32", True)


def test_backend_waves_match_reference_on_both_contexts():
    _case_backend_waves("k32")


def test_schedule_pod_matches_reference():
    _case_schedule_pod("k32")
