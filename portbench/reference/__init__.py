"""The benchmark's plain float32 reference of both configurations. It
imports nothing of the program under test, nor JAX."""
