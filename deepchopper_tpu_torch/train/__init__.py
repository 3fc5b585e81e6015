"""Training and evaluation: loss, metrics, config tree, step and the epoch loop."""
