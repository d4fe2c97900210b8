"""Hand-written CUDA kernels of the port and their build.

Sources (``*.cu``) sit beside this file and are compiled with ``nvcc`` at
first use (``build.py``); nothing is built on import.
"""
