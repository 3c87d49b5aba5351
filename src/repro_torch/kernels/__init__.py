"""The sparsify + error-feedback CUDA kernels, their plain versions and
their dispatch (``ops``)."""
