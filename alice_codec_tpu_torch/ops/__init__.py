"""Plain-PyTorch building blocks and the kernel wrappers of the port."""
