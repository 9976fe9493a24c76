"""PyTorch/CUDA port of the serving system, for NVIDIA Hopper (H100).

Mirrors the layout of the JAX package ``repro`` (the reference, which
this package never imports): ``configs/``, ``kernels/<name>/{kernel,
ops,ref}.py`` with hand-written CUDA sources under ``kernels/csrc/``,
``models/`` and ``serving/``. Entry points place tensors on the card
(``device="cuda"``) unless the caller asks for the CPU, and raise when
no card is present.
"""
