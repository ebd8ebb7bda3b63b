"""apps of the PyTorch/CUDA port."""
