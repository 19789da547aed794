"""Synthetic data and federated partitions: numpy copies of what the
paper's main path uses from ``repro.data``."""
from repro_torch.data.federated import (  # noqa: F401
    client_batches,
    iid_partition,
    rho_weights,
    round_batches,
)
from repro_torch.data.synthetic import (  # noqa: F401
    SyntheticImageDataset,
    make_image_dataset,
)
