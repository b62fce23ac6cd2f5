"""Training of the port: ray prep, the train step, checkpoints, the trainer."""
