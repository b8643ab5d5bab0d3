"""Fleet meta optimizers."""
