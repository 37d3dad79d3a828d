"""Selective scan (plain PyTorch and the CUDA kernel), CrossScan/CrossMerge."""
