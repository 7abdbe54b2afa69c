"""The plain reference of the served path, in float64 NumPy.

It imports numpy alone: nothing of JAX, of the JAX package or of the port.
It takes the IRs and the input blocks the benchmark made from the seed,
computes its own spectra, and renders output blocks of chosen voices.
"""
