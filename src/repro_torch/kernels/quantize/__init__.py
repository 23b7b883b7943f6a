"""Int8 block quantization by absmax (gradient compression) for Hopper."""
