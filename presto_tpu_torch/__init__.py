"""presto_tpu_torch: the PyTorch/CUDA port of presto_tpu.

The same SQL engine on torch tensors: columnar batches on one device,
expressions evaluated by a tensor interpreter, relational operators as
sort/segment/gather tensor code, and the JAX package's two Pallas TPU
kernels rewritten as CUDA kernels for Hopper (``csrc/``). The package
layout mirrors ``presto_tpu`` so each module's counterpart sits at the
same path. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``.
"""
__version__ = "0.1.0"
