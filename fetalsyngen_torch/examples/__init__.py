"""Runnable walkthroughs of the port's public API (ports of ``examples/``)."""
