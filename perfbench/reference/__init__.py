"""The plain reference, in plain PyTorch, in float32 with TF32 off, written
from the published descriptions: the parts every family shares
(``model.py``: RMSNorm, RoPE on halves, grouped-query causal attention with
an optional sliding window, the output head) and each family's layer
(``families/<family>.py``; the mixture of experts: a top-k softmax router
renormalised over its k choices, SwiGLU experts and the configuration's
capacity rule). It imports nothing of the program and takes nothing the
program made: weights are made again from the seed (``perfbench.weights``),
routing, capacity drops and the positions the cache holds are worked out
here. ``Prec("fp8")`` is the control: every product's operands rounded to
float8 (e4m3 forward, e5m2 gradients, one scale a tensor).
"""
