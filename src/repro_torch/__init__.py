"""PyTorch/CUDA port of the Speed-ANN reproduction.

Mirrors ``repro``'s layout (``ann/``, ``core/``, ``kernels/``, ``quant/``);
the distance kernels are hand-written CUDA C++ for Hopper (``csrc/``), built
with nvcc at first use.  Entry points run on the CUDA device unless the
caller names another.
"""
