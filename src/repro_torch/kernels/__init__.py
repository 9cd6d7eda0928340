"""Hand-written Hopper kernels of the port, their plain versions and ops."""
