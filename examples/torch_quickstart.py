"""Quickstart for the PyTorch port: the SFL-GA protocol end to end.

Mirrors ``examples/quickstart.py`` on ``repro_torch``: trains the paper's
CNN (light variant) with 10 federated clients on a synthetic MNIST-like
task, SFL-GA against traditional SFL, and prints accuracy and traffic
per round; then prices sfl_ga under the int8/int4 cut-layer codecs.

Runs on the GPU by default (the eq. 5 aggregation and the int codecs are
the port's CUDA kernels there) and fails without one; ``--device cpu``
runs the same protocol on the CPU with the kernels' plain versions.

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.configs.paper_cnn import LIGHT_CONFIG
from repro_torch.core.simulator import FedSimulator, SimConfig
from repro_torch.data import (client_batches, iid_partition,
                              make_image_dataset, rho_weights)
from repro_torch.models import cnn
from repro_torch.sysmodel.traffic import round_traffic_bytes


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--rounds", type=int, default=40)
    args = ap.parse_args(argv)

    # 1) data: synthetic MNIST-like, split across 10 clients (IID)
    ds = make_image_dataset("mnist", n=2400, seed=0)
    train, test = ds.split(0.9)
    parts = iid_partition(len(train.x), n_clients=10, seed=0)
    rho = rho_weights(parts)  # the paper's rho^n = D^n / D

    for scheme in ("sfl_ga", "sfl"):
        # 2) simulator: cut the V=5 CNN at v=2 -- conv layers on clients
        sim = FedSimulator(
            LIGHT_CONFIG,
            SimConfig(scheme=scheme, cut=2, n_clients=10, batch=16, lr=0.1),
            rho=rho, seed=0, device=args.device)

        # 3) federated rounds: upload smashed data, server update,
        #    aggregated-gradient broadcast (eq. 5), client backprop
        rng = np.random.RandomState(0)
        for _ in range(args.rounds):
            xs, ys = client_batches(train, parts, batch=16, rng=rng)
            metrics = sim.run_round(xs[:, None], ys[:, None])

        acc = sim.evaluate(test.x, test.y)
        comm = sim.comm_bytes_per_round()
        print(f"{scheme:>7}: acc={acc:.3f} loss={metrics['loss']:.3f} "
              f"traffic={comm['total_bytes'] / 1e6:.3f} MB/round "
              f"(up {comm['up_bytes'] / 1e6:.3f} / down "
              f"{comm['down_bytes'] / 1e6:.3f}) [{sim.device}]")

    # 4) the same workload priced under compressed cut-layer transports
    print("\nsfl_ga per-round traffic by transport codec:")
    for codec in ("fp32", "int8", "int4"):
        t = round_traffic_bytes(
            "sfl_ga", n_clients=10,
            smashed_elems=cnn.smashed_numel(LIGHT_CONFIG, 2) * 16,
            label_bits=16 * 32,
            client_model_bits=cnn.phi(LIGHT_CONFIG, 2) * 32,
            uplink_codec=codec, downlink_codec=codec)
        print(f"  {codec:>5}: {t['total_bytes'] / 1e6:.3f} MB/round")


if __name__ == "__main__":
    main()
