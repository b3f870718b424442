"""Training: data and shards, losses, the optimizer, the trainer, early
stopping, and weights and checkpoints."""
