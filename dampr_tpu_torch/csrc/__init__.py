"""Hand-written Hopper kernels (CUDA C++ sources) and their builder."""
