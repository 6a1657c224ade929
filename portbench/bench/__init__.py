"""The harness: manifest, drivers, tracing and the correctness checks."""
