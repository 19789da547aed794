"""Core of the port (mirrors ``repro.core``): the serve engine, and the
paper's protocol -- the gradagg boundary operators, the scheme engine
and the CNN-scale federated simulator."""
