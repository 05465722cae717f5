"""The store-driven loop over the capacity fleet: the B3 configuration
(the 21-point RequestedToCapacityRatio profile over ten scored resources,
4 keys) in two waves of 16 (a cold and a chained launch) and the B4 one
(20 keys, K 32) in one wave of 32 (one program of the reference's: each
takes ~60-100 s to compile at K 32), both packages' Schedulers, bindings,
PodScheduled=False diagnoses and rng equal (tests/test_torch_capacity.py's
case)."""

import jax
import pytest
from jax._src import compilation_cache

from tests.test_torch_capacity import (  # noqa: F401 (fixtures)
    _case_store_loop,
    _own_process_state,
    _port_registry,
)


@pytest.fixture(autouse=True, scope="module")
def _no_shared_compilation_cache():
    """This file's programs compile outside the persistent compilation
    cache the test workers share: JAX writes a cache entry in place (not by
    a rename), and (de)serializing these K 32 executables through that
    cache crashed a worker (a segfault in compilation_cache's put, and once
    in its get) while other workers compiled the same programs."""
    jax.config.update("jax_enable_compilation_cache", False)
    compilation_cache.reset_cache()
    yield
    jax.config.update("jax_enable_compilation_cache", True)
    compilation_cache.reset_cache()


@pytest.mark.parametrize("variant,wave", [("rtc21", 16), ("k32", 32)])
def test_store_loop_matches_reference(variant, wave, monkeypatch):
    _case_store_loop(variant, monkeypatch, wave)
