"""Analog-matmul kernels: the plain version, the CUDA kernel and dispatch.

  prng           - Threefry-2x32 + Box-Muller on int64 words, raw uint32 keys
  ref            - plain PyTorch analog matmul (one request per leading row)
  analog_matmul  - wrapper of csrc/analog_matmul.cu (built with nvcc, ctypes)
  ops            - operand preparation + public entry points
  dispatch       - "auto" | "cuda" | "tile"
"""
