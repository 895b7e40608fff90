"""CPU tests of the benchmark harness and its reference (the card-only ones
carry the ``cuda`` marker)."""
