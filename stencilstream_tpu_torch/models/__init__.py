"""Example applications on the PyTorch/CUDA port."""
