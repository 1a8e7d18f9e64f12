# Hand-written Hopper kernels for the serving path, each beside its plain
# PyTorch version:
#   flash_attention — causal / sliding-window / kv_len / GQA attention
#                     forward (csrc/flash_fwd.cu), for prefill and decode
#   rmsnorm         — fused single-pass norm (csrc/rmsnorm.cu)
#   moe_gmm         — grouped expert GEMM of the MoE FFN (csrc/moe_gmm.cu)
#   ssd_scan        — Mamba2 SSD chunked scan with its final state
#                     (csrc/ssd_scan.cu), for the SSM and hybrid prefill
# ops.py dispatches by device (CPU → plain, CUDA → kernel) and counts
# launches; build.py compiles csrc/ with nvcc at first use.
from . import ops  # noqa: F401
