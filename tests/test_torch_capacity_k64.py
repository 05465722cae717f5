"""The B4 configuration at 40 topology keys (K 64, the traffic's
constraints and terms on key slots 33-36, past the matched key mask's
first word) under the default profile: K2's non-dedup tier and K4
through schedule_pod, the port's plain versions against the JAX package,
every output equal (tests/test_torch_capacity.py's cases)."""

from tests.test_torch_capacity import (  # noqa: F401 (fixtures)
    _case_batched_assign,
    _case_schedule_pod,
    _own_process_state,
    _port_registry,
    waves,
)


def test_batched_assign_without_dedup_matches_reference(waves):
    _case_batched_assign(waves, "k64", False)


def test_schedule_pod_matches_reference():
    _case_schedule_pod("k64")
