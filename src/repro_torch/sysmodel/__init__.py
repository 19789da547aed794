"""System model (numpy): the copies of ``repro.sysmodel`` that the serve
slice prices its wire and its per-token latency with."""
