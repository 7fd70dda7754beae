"""PyTorch/CUDA port of ugaitnet_tpu.

Mirrors the JAX package's module paths (``core``, ``data``, ``models``,
``ops``, ``train``, ``utils``) so each counterpart is found by name.  Public
functions keep the JAX package's layouts: volumes ``(B, T, H, W, C)``,
signatures ``(B, P, D)``, labels ``(B,)``.  Entry points run on the CUDA
device unless the caller passes ``device="cpu"``.
"""
