"""Device math: transforms, partitioning, mixing and the MAC kernels."""
