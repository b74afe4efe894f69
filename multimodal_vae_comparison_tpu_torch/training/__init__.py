"""Training: optimizers with optax's update rules and the train step."""
