"""System model (numpy): the copies of ``repro.sysmodel`` that the port
prices its wire with -- per-round training traffic, serving legs, and
per-token latency."""
