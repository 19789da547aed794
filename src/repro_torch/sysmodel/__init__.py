"""System model: the copies of ``repro.sysmodel`` that the port prices
its wire and its rounds with -- per-round training traffic, serving legs,
per-token latency, and the wireless, computation and privacy models of
the CCC strategy (numpy, and torch tensors where ``backend`` says so)."""
