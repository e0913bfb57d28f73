"""Training: the loss and the one-device training step."""
