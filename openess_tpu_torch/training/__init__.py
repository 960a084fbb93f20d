"""Model construction, optimizer, steps, trainer and checkpoints."""
