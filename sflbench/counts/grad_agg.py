"""Bytes of kernel B1 (eq. 5's aggregation, ``grad_agg``) a launch (frozen).

out = sum_n rho_n g_n over (N, M) float32: N M 4 bytes read, M 4 written,
N 4 of weights. Under sfl_ga the step launches it once, on the smashed
data's gradient: N = the cohort, M = b S d.
"""


def launch_bytes(n: int, m: int) -> int:
    return 4 * n * m + 4 * m + 4 * n


def launches_per_step(model: dict, traffic: dict) -> list:
    """[(kernel, bytes)] a training step launches of B1."""
    if traffic["scheme"] != "sfl_ga":
        return []
    m = traffic["batch"] * traffic["seq"] * model["d_model"]
    return [("B1", launch_bytes(traffic["cohort"], m))]
