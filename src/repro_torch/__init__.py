"""PyTorch/CUDA port of the dynamic-precision analog serving stack.

A second package beside ``repro`` (the JAX reference, which it never
imports). The layout mirrors ``repro`` so every module has an obvious
counterpart:

  kernels/  - counter-based Threefry noise, the plain analog matmul, the
              hand-written CUDA kernel (``csrc/analog_matmul.cu``) and the
              backend dispatch ("auto" | "cuda" | "tile")
  core/     - noise models and ``analog_dot`` (the per-site choke point),
              energy accounting, noise bits, per-layer precision profiles
  quant/    - affine fake-quant
  models/   - the dense and griffin LMs with analog matmul hooks
  configs/  - model configurations
  serving/  - bucket-batched ``ServingEngine``: batch-synchronous or
              continuous (per-tier decode slot pools), uniform-K and
              per-layer profile tiers
  bridge    - numpy parameter trees in the reference layout -> torch
  tree      - nested-dict trees (``map_leaves``, ``leaves``)

Entry points take an explicit ``device`` and default to ``"cuda"``; on a
machine without a card they raise instead of running on the CPU.
"""
