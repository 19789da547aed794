from repro_torch.checkpoint.checkpoint import (  # noqa: F401
    StackedLeaf, load_checkpoint, load_checkpoint_meta, save_checkpoint)
