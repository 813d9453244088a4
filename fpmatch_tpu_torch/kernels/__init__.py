"""Hand-written CUDA kernels (sources under csrc/, built at first use) with a
plain PyTorch version beside each. Nothing is compiled or loaded on import."""
