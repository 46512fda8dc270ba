"""Ops of the port: plain torch functions on tensors, plus the fused
modconv level whose CUDA kernel replaces the JAX package's Pallas kernel."""
