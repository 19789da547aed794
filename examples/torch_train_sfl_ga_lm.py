"""SFL-GA split training of a ~100M-parameter granite-family LM on the
PyTorch port: the port's run of ``examples/train_sfl_ga_lm.py``.

Four clients train the ``100m`` preset (4 layers, d 512) on synthetic
token streams for a few hundred steps through the port's launcher
(``repro_torch.launch.train``, LM mode); the loss falls from ~10 as the
model learns the stream's next-token structure. The cut-layer boundary
runs the protocol engine, so ``--uplink-codec int8 --downlink-codec
int8`` trains against the quantized reconstruction (kernels B2/B3 on
the card; the sfl_ga backward's eq. 5 is kernel B1) and ``--tau`` runs
local steps; the traffic a round is printed at the end.

Runs on the card by default and fails without one; ``--device cpu``
runs the plain versions on the CPU.

Run:  PYTHONPATH=src python examples/torch_train_sfl_ga_lm.py [--steps 300]
      PYTHONPATH=src python examples/torch_train_sfl_ga_lm.py \
          --uplink-codec int8 --downlink-codec int8 --device cpu --steps 20
"""
import argparse

from repro_torch.launch import train as train_mod


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--arch", default="granite-8b")
    p.add_argument("--tau", type=int, default=1)
    p.add_argument("--uplink-codec", default="fp32")
    p.add_argument("--downlink-codec", default="fp32")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--checkpoint", default="results/torch_sfl_ga_100m.ckpt")
    args = p.parse_args(argv)
    return train_mod.main([
        "--arch", args.arch, "--preset", "100m", "--scheme", "sfl_ga",
        "--cut", "1", "--clients", "4", "--batch", "2", "--seq", "128",
        "--steps", str(args.steps), "--lr", "0.1", "--log-every", "20",
        "--tau", str(args.tau), "--uplink-codec", args.uplink_codec,
        "--downlink-codec", args.downlink_codec, "--device", args.device,
        "--checkpoint", args.checkpoint,
    ])


if __name__ == "__main__":
    main()
