"""Hand-written Hopper kernels of the port and their PyTorch wrappers.

Nothing here builds or imports a compiler at import time: the CUDA
libraries are compiled at the first launch on a card (``build.py``)."""
