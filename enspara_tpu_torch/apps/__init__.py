"""Command-line apps of the port: ``cluster``, ``reassign`` and
``implied_timescales``."""
