"""PyTorch/CUDA port of ws_mgmap_tpu for NVIDIA Hopper (sm_90a).

The JAX package ``ws_mgmap_tpu`` is the reference this package is held
against. Public functions keep its channels-last (NHWC) layout. Nothing
here imports JAX or ``ws_mgmap_tpu``: what the port needs from there is
copied. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; the hand-written Hopper kernels live in
``ops/kernels/`` with a plain PyTorch twin beside each.
"""
