"""PyTorch + CUDA port of the ``repro`` model runtime, for one NVIDIA H100.

Mirrors ``repro``'s layout (``configs/``, ``core/``, ``kernels/``,
``models/``, ``runtime/``, ``launch/``) so each module has a named
counterpart. The package imports ``torch``, ``numpy`` and the standard
library only: nothing of JAX and nothing of ``repro``. What it needs from
``repro``'s pure-Python modules it keeps as its own copy.

Entry points put tensors on ``cuda`` unless the caller passes
``device="cpu"``. Kernel wrappers dispatch by the tensor's device: a CPU
tensor takes the kernel's plain PyTorch version, a CUDA tensor launches
the hand-written kernel (built from ``kernels/csrc`` at first use).
"""

DEFAULT_DEVICE = "cuda"
