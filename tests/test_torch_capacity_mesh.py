"""The B4 configuration at 20 topology keys (K 32) on node shards: K6's
plain version on 8 shards and K7's, the port's plain versions against the
JAX package, every output equal (tests/test_torch_capacity.py's cases)."""

from tests.test_torch_capacity import (  # noqa: F401 (fixtures)
    _case_sharded_assign,
    _case_wave_matrix,
    _own_process_state,
    _port_registry,
    waves,
)


def test_sharded_assign_on_8_shards_matches_k2_and_reference(waves):
    _case_sharded_assign(waves, "k32")


def test_wave_matrix_matches_reference(waves):
    _case_wave_matrix(waves, "k32")
