"""Command-line apps of the port: ``cluster`` and ``reassign``."""
