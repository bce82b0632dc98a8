"""The MoM assembly tile: plain torch version (ref), CUDA kernel wrapper
(kernel) and the public entry point (ops)."""
