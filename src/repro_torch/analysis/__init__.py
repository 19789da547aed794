"""Roofline analysis of the port's steps (mirrors ``repro.analysis``)."""
