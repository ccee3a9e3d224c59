"""Models of the port: the dense GPT and the JAX params bridge."""
