"""Hand-written CUDA kernels of the port, their plain versions, and the
dispatch policy (``ops.resolve_impl``)."""
