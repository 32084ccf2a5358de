"""Denoisers (torch.nn) and the flax-to-torch weight bridge."""
