"""The share of the rows the held experts' products compute that carry a
routed (token, choice) pair: 100 x ``moe_pairs_kept`` / ``moe_expert_rows``
over the profiled steps, from the program's ``obs`` counters
(``run.counters``). A forward computes held x C rows (C the capacity over
all the experts); the rest is padding that capacity costs the products.
The program counts its server-side MoE forwards (the client layers run
under ``vmap``), the backward's recompute under remat included.

Nothing where the program gives neither counter. Moves
``train_tokens_per_s``.
"""

LAYER = "expert layer, models/moe.py moe_apply"
UNIT = "%"
MOVES = "train_tokens_per_s"


def read(run):
    rows = run.counters.get("moe_expert_rows")
    kept = run.counters.get("moe_pairs_kept")
    if not rows or kept is None:
        return None
    return 100.0 * float(kept) / float(rows)
