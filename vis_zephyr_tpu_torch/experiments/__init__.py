"""Ports of the repository's experiment probes (`experiments/*.py`)."""
