"""Model configurations of the port (copied from ``repro.configs``)."""
