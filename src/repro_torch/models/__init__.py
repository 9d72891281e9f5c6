"""The port's model families (dense, ssm, hybrid) in PyTorch, with the
JAX package's layouts."""
