"""Device ops of the decision step (plain functions on tensors)."""
