"""Synthetic data and federated partitions: numpy copies of
``repro.data``'s image data, LM token stream and partitions."""
from repro_torch.data.federated import (  # noqa: F401
    CyclicPartition,
    client_batches,
    dirichlet_partition,
    iid_partition,
    replacement_fraction,
    rho_weights,
    round_batches,
)
from repro_torch.data.synthetic import (  # noqa: F401
    SyntheticImageDataset,
    make_image_dataset,
    synthetic_token_batches,
)
