"""The fused SpaceSaving± bank update: CUDA kernel, plain version, ops."""
