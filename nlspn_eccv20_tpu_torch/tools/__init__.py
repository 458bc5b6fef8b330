"""Command-line tools of the port that need the CUDA card."""
