"""Diffusion core: schedules, process math, conditioning, samplers, conformal."""
