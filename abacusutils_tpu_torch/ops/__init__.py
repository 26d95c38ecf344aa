"""Deposit and P(k) binning: plain PyTorch versions and CUDA kernel wrappers."""
