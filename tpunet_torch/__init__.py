"""tpunet_torch: the PyTorch/CUDA port of tpunet for NVIDIA Hopper.

The JAX package ``tpunet`` is the reference; this package mirrors its
module layout and names. It never imports JAX or ``tpunet``. Entry
points run on ``device="cuda"`` unless the caller passes
``device="cpu"``, where every hand-written kernel is replaced by its
plain PyTorch version.
"""
