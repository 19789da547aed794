"""Serving core of the port (mirrors ``repro.core``)."""
