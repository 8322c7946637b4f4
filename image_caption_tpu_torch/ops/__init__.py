"""Attention, masks and the CUDA kernels with their build."""
