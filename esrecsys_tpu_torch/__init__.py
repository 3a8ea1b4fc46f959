"""PyTorch/CUDA port of ``esrecsys_tpu``.

The JAX package stays the reference; this package mirrors its module names
(``models/playlist.py`` here is the counterpart of
``esrecsys_tpu/models/playlist.py``) and imports ``torch``, ``numpy`` and
the standard library only. Every TPU kernel on a ported path becomes a
hand-written Hopper kernel under ``csrc/`` with a plain PyTorch version
beside it (``kernels/``): CPU tensors take the plain version, CUDA tensors
launch the kernel or raise.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(:func:`esrecsys_tpu_torch.core.device.resolve_device`).
"""

__version__ = "0.1.0"
