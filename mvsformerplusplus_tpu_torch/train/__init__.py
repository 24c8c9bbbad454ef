"""Training: the two-group AdamW and its schedule (optim), one optimizer
step with optional micro-batch accumulation (step) and the training loop
(trainer)."""
