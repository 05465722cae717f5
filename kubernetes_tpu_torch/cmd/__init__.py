"""Entry points (reference: cmd/). The port has the scheduler's."""
