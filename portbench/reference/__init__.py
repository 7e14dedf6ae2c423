"""The plain references that decide ``correct``: plain PyTorch, importing
neither JAX, the JAX package ``repro`` nor the port ``repro_torch``.  They
take the benchmark's own inputs and work out again what the program
derives from them."""
