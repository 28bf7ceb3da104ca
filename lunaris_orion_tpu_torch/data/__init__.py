"""Data tier of the port: the sprite-shard dataset, its batch loader and
the synthetic corpus writer."""

from lunaris_orion_tpu_torch.data.dataset import (  # noqa: F401
    BatchLoader,
    SpriteDataset,
    train_val_split,
)
