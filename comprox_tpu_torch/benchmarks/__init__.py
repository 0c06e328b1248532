"""Primitive-cost probes of the port (``probes.py``); no codec module imports
this package."""
