"""Plain references of architectures the JAX package does not have: forward
passes in plain `torch`, importing nothing of `cppf2_torch`, that the tests
hold the port's modules against."""
