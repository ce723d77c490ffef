"""Hand-written Hopper kernels (CUDA C++) and the nvcc build that loads them."""
