"""Byte tokenizer and synthetic corpora (copies of the JAX package's)."""
