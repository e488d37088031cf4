"""The training substrate: next-token loss, AdamW, checkpoints and the
training loop (the port of the JAX package's ``repro.training``)."""
