"""The port's model families (dense, moe, ssm, hybrid) in PyTorch, with the
JAX package's layouts."""
