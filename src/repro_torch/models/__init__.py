"""Model code of the port (mirrors ``repro.models``)."""
