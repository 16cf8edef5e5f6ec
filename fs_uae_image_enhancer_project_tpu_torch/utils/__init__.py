"""Utilities: the timing harness and a jax-free copy of JAX's ``randint``."""
