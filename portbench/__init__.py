"""The benchmark of r3det_tpu_torch on NVIDIA H100 cards."""
