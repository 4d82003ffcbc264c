"""tod_tpu_torch — the PyTorch/CUDA port of tod_tpu for NVIDIA Hopper.

The JAX package ``tod_tpu`` is the reference this package is held against;
this one imports ``torch`` and ``numpy`` only. Layout mirrors the reference:

  ops/       image pyramid, FAST/Harris/NMS, ORB, SIFT, depth, the
             global radius k-NN and the segmented matchers
  geometry/  adjacency graphs, graph-constrained RANSAC, rigid transforms,
             the global-kNN and the segmented two-tier frame detection
  models/    FusedDetector on the global-kNN and segmented serving paths
  csrc/      hand-written CUDA kernels (built by ``kernels.py`` at first use)

Every function takes its tensors on an explicit device; the CUDA kernels run
for CUDA tensors and their plain PyTorch twins for CPU tensors.
"""

__version__ = "0.1.0"
