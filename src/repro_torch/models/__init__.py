"""Dense decoder models in PyTorch, with the JAX package's layouts."""
