"""Host-side utilities of the port: the TensorBoard metrics writer and the
stage timer and profiler trace."""
