"""The store-driven loop over the capacity fleet: the B3 configuration
(the 21-point RequestedToCapacityRatio profile over ten scored resources,
4 keys) in two waves of 16 (a cold and a chained launch) and the B4 one
(20 keys, K 32) in one wave of 32 (one program of the reference's: each
takes ~60-100 s to compile at K 32), both packages' Schedulers, bindings,
PodScheduled=False diagnoses and rng equal (tests/test_torch_capacity.py's
case)."""

import pytest

from tests.test_torch_capacity import (  # noqa: F401 (fixtures)
    _case_store_loop,
    _own_process_state,
    _port_registry,
)


@pytest.mark.parametrize("variant,wave", [("rtc21", 16), ("k32", 32)])
def test_store_loop_matches_reference(variant, wave, monkeypatch):
    _case_store_loop(variant, monkeypatch, wave)
