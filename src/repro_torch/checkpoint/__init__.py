from repro_torch.checkpoint.checkpoint import (  # noqa: F401
    load_checkpoint, load_checkpoint_meta, save_checkpoint)
