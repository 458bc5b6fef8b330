"""Command-line tools of the port: the dataset tooling (split JSONs,
KITTI DC preparation) and the profilers and kernel tools, which need the
CUDA card."""
