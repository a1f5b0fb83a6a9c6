"""CPU tests of the benchmark harness; the card tests carry the ``cuda``
marker and skip without a card."""
