"""Bytes of kernels B2 (int codec encode, ``quantize_pack``) and B3
(decode and aggregate, ``dequant_agg_reduce``) a launch (frozen).

int8 over flat 256-element tiles, one float32 scale a tile:
* B2 over R rows of M values: R M 4 read, R M written (codes), R M / 256
  4 written (scales), and R 8 of per-row seeds when each row has its own;
* B3 decoding R rows of M codes: R M + R M / 256 4 read, 4 of the weight,
  R M 4 written.
A sfl_ga step with an int8 uplink encodes the K clients' smashed data in
one B2 launch and decodes it in one B3 launch; an int8 downlink encodes
and decodes the one aggregate (R = 1) once each.
"""

TILE = 256


def encode_bytes(rows: int, m: int, per_row_seeds: bool) -> int:
    return rows * m * 4 + rows * m + rows * (m // TILE) * 4 \
        + (rows * 8 if per_row_seeds else 0)


def decode_bytes(rows: int, m: int) -> int:
    return rows * m + rows * (m // TILE) * 4 + 4 + rows * m * 4


def launches_per_step(model: dict, traffic: dict) -> list:
    """[(kernel, bytes)] a training step launches of B2 and B3."""
    m = traffic["batch"] * traffic["seq"] * model["d_model"]
    m += (-m) % TILE
    k = traffic["cohort"]
    out = []
    if traffic["uplink_codec"] == "int8":
        out += [("B2", encode_bytes(k, m, True)), ("B3", decode_bytes(k, m))]
    if traffic["downlink_codec"] == "int8" and traffic["scheme"] == "sfl_ga":
        out += [("B2", encode_bytes(1, m, False)), ("B3", decode_bytes(1, m))]
    return out
