"""Training on one device: the train and eval steps, ``fit``, the loss,
the metrics and the checkpoints."""
