"""Model configurations of the port (its own copies: nothing is read from
``repro``)."""
