"""Physics solvers."""
