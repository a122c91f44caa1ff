"""Entry points of the port (run with ``python -m``)."""
