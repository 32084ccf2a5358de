"""Checkpointing of the training and fine-tuning state."""
