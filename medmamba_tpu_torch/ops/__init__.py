"""Selective scan (plain PyTorch and CUDA kernels), CrossScan/CrossMerge."""
