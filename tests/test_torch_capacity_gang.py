"""The B4 configuration at 20 topology keys (K 32) on the gang path:
gangs in Required and Preferred mode through both packages' planner and
run_gang (K1 + K5's plain versions), every output equal
(tests/test_torch_capacity.py's case)."""

import pytest

from tests.test_torch_capacity import _case_gang, _own_process_state  # noqa: F401 (autouse)


@pytest.mark.parametrize("mode", ["Required", "Preferred"])
def test_gang_matches_reference(mode):
    _case_gang("k32", mode)
