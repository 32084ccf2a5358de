"""Data parallelism and frame-axis sequence parallelism over
`torch.distributed` (`parallel/mesh.py`)."""
