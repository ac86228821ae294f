"""doc2tex_tpu_torch — the PyTorch + CUDA port of doc2tex_tpu.

Runs batched crop recognition with the released ViT + TFM recognizers on an
NVIDIA GPU.  Plain tensor code is PyTorch; the one TPU kernel on this path
(beam decode attention) is a hand-written CUDA kernel for Hopper
(``csrc/decode_attention.cu``), built with nvcc at first use and loaded with
ctypes.  Every entry point takes a ``device`` argument that defaults to
``"cuda"``; the CPU is used only when the caller asks for it.

The package imports torch, numpy and the standard library only: the release
weights (flax msgpack) are read by ``_msgpack.py`` and the YAML configs by
``config.py``.
"""

__version__ = "0.1.0"
