"""Plain PyTorch Montgomery tier, the two CUDA kernel wrappers and their build."""
