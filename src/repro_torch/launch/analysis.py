"""Roofline analysis of a step (port of ``repro.launch.analysis``): the
analytic FLOP and byte model, the collectives a traced step issues, and
the three terms (compute, memory, collective) at an H100's constants.

The analytic half (``_avg_causal_ctx`` … ``analytic_cell``,
``model_flops_for_cell``) is ``repro``'s, line for line, so both give the
same floats for every config and shape. ``repro`` parses the collectives
out of XLA's compiled HLO; PyTorch has no HLO, so the dry run
(``launch/dryrun.py``) records each collective as the process group sees
it while one step is traced, and ``roofline_from_trace`` costs them with
``repro``'s ring formulas. A Python loop over layers and microbatches
issues each collective as often as it runs, so no trip-count correction is
needed.

Hardware constants: NVIDIA H100 SXM (public datasheet): 989.4 TFLOP/s dense
bf16, 3.35 TB/s HBM3, 80 GB HBM; NVLink 4 at 450 GB/s a direction between
the 8 GPUs of a node; 400 Gb/s InfiniBand (50 GB/s) a GPU between nodes.
A collective's group that spans more than one node of ``NODE_SIZE`` ranks
rides InfiniBand, and so does every group over the ``"pod"`` axis.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass, field
from typing import Any, Dict, Iterable, Optional, Sequence

PEAK_FLOPS = 989.4e12        # dense bf16 FLOP/s per GPU
HBM_BW = 3.35e12             # bytes/s per GPU
NVLINK_BW = 450e9            # bytes/s per GPU and direction, within a node
IB_BW = 50e9                 # bytes/s per GPU, between nodes
HBM_BYTES = 80 * 10**9       # device memory per GPU
NODE_SIZE = 8                # GPUs of one NVLink node
GiB = 1 << 30


@dataclass
class CollectiveOp:
    kind: str                  # all-reduce | all-gather | reduce-scatter | all-to-all | ...
    result_bytes: int
    group_size: int
    crosses_pods: bool         # rides InfiniBand (spans nodes, or the "pod" axis)
    cost_bytes: float          # effective per-device wire bytes (ring)
    trip_mult: int = 1         # always 1: a traced loop issues every trip


def ring_cost(kind: str, b: int, n: int) -> float:
    """``repro``'s ring cost per device: ``b`` is the per-device result
    (all-gather: the full gathered result; reduce-scatter: the scattered
    shard)."""
    if n <= 1:
        return 0.0
    if kind == "all-reduce":
        return 2.0 * b * (n - 1) / n
    if kind == "all-gather":
        return b * (n - 1) / n
    if kind == "reduce-scatter":
        return b * (n - 1)
    if kind == "all-to-all":
        return b * (n - 1) / n
    return float(b)                          # collective-permute, broadcast


def crosses_nodes(ranks: Sequence[int], node_stride: int = NODE_SIZE) -> bool:
    """Whether a group of global ranks spans more than one node."""
    return len({r // node_stride for r in ranks}) > 1


def collective_op(kind: str, result_bytes: int, ranks: Sequence[int],
                  over_pod: bool = False, node_stride: int = NODE_SIZE) -> CollectiveOp:
    n = len(ranks)
    return CollectiveOp(kind, int(result_bytes), n,
                        bool(over_pod or crosses_nodes(ranks, node_stride)),
                        ring_cost(kind, int(result_bytes), n))


@dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    # analytic per-device quantities (exact matmul accounting; see
    # analytic_cell for the byte-model assumptions)
    flops_per_device: float
    bytes_per_device: float
    # the traced step's collectives (NVLink within a node, IB across)
    collective_bytes_ici: float
    collective_bytes_dcn: float
    n_collectives: int
    # the three terms (seconds)
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    # usefulness
    model_flops: float            # 6·N_active·D (train) / 2·N_active·D (decode)
    analytic_flops_global: float
    useful_ratio: float
    # roofline fraction: useful work / (what the dominant term costs)
    step_time_s: float = 0.0
    roofline_frac: float = 0.0
    # the traced step's own counts per device (recorded beside the analytic
    # ones for cross-checking; not used for the terms)
    hlo_flops_per_device: float = 0.0
    hlo_bytes_per_device: float = 0.0
    # memory fit
    memory_analysis: Dict[str, Any] = field(default_factory=dict)
    per_device_hbm_bytes: int = 0
    fits_hbm: bool = True
    collectives_by_kind: Dict[str, float] = field(default_factory=dict)
    assumptions: str = ""
    notes: str = ""

    def to_json(self) -> Dict[str, Any]:
        return asdict(self)


def roofline_from_trace(collectives: Iterable[CollectiveOp], *, arch: str, shape: str,
                        mesh_desc: str, chips: int, model_flops: float,
                        analytic: "AnalyticCell", min_bytes: float = 0.0,
                        traced_flops_per_device: float = 0.0,
                        memory: Optional[Dict[str, Any]] = None,
                        per_device_bytes: int = 0, hbm_limit: int = HBM_BYTES,
                        notes: str = "") -> RooflineReport:
    """``repro``'s ``roofline_from_compiled`` over a traced step's record:
    its collectives, its FLOPs per device, its memory record and peak
    bytes per device. ``min_bytes``: the cell's irreducible global HBM
    traffic per step (decode: params + cache read once; prefill/train:
    params); the ideal is max(compute ideal, min-bytes ideal)."""
    cols = list(collectives)
    ici = sum(c.cost_bytes for c in cols if not c.crosses_pods)
    dcn = sum(c.cost_bytes for c in cols if c.crosses_pods)
    by_kind: Dict[str, float] = {}
    for c in cols:
        by_kind[c.kind] = by_kind.get(c.kind, 0.0) + c.cost_bytes
    compute_s = analytic.flops_per_device / PEAK_FLOPS
    memory_s = analytic.bytes_per_device / HBM_BW
    collective_s = ici / NVLINK_BW + dcn / IB_BW
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    dominant = max(terms, key=terms.__getitem__)
    # step-time model: compute/memory overlap perfectly; collectives half-
    # exposed (latency hiding over the layer loop)
    step_s = max(compute_s, memory_s) + 0.5 * collective_s
    ideal_s = max(model_flops / (chips * PEAK_FLOPS),
                  min_bytes / (chips * HBM_BW))
    return RooflineReport(
        arch=arch, shape=shape, mesh=mesh_desc, chips=chips,
        flops_per_device=analytic.flops_per_device,
        bytes_per_device=analytic.bytes_per_device,
        collective_bytes_ici=ici, collective_bytes_dcn=dcn,
        n_collectives=len(cols),
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        dominant=dominant,
        model_flops=model_flops,
        analytic_flops_global=analytic.flops_global,
        useful_ratio=(model_flops / analytic.flops_global)
        if analytic.flops_global else 0.0,
        step_time_s=step_s,
        roofline_frac=(ideal_s / step_s) if step_s > 0 else 0.0,
        hlo_flops_per_device=traced_flops_per_device,
        memory_analysis=dict(memory or {}), per_device_hbm_bytes=int(per_device_bytes),
        fits_hbm=(per_device_bytes <= hbm_limit) if per_device_bytes else True,
        collectives_by_kind=by_kind, assumptions=analytic.assumptions,
        notes=notes,
    )


def model_flops_for_cell(cfg, shape, model) -> float:
    """Analytic useful FLOPs for one step of this cell."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * shape.global_batch


# ===========================================================================
# Analytic FLOPs / bytes model
#
# ``repro``'s model, copied line for line: the matmul accounting is exact;
# the byte traffic states its assumptions inline. The traced FLOP count of
# a dry-run cell is recorded beside it for cross-checking.
# ===========================================================================
def _avg_causal_ctx(S: int, window: int) -> float:
    """Mean attended context per query under causal(+window) masking."""
    if window <= 0 or window >= S:
        return (S + 1) / 2.0
    # first `window` queries attend i+1, the rest attend `window`
    head = window * (window + 1) / 2.0
    return (head + (S - window) * window) / S


def _attn_layer_flops(cfg, B: int, S: int, ctx: float) -> float:
    hd, Hq, Hkv, d = cfg.head_dim_, cfg.n_heads, cfg.n_kv_heads, cfg.d_model
    qkv = 2.0 * B * S * d * (Hq + 2 * Hkv) * hd
    scores_av = 2.0 * B * Hq * S * ctx * hd * 2.0
    wo = 2.0 * B * S * Hq * hd * d
    return qkv + scores_av + wo


def _mlp_flops(B: int, S: int, d: int, ff: int) -> float:
    return 6.0 * B * S * d * ff          # swiglu: 3 matmuls


def _moe_flops(cfg, B: int, S: int) -> float:
    m = cfg.moe
    T = B * S
    router = 2.0 * T * cfg.d_model * m.n_experts
    experts = 6.0 * T * m.top_k * m.capacity_factor * cfg.d_model * \
        (m.d_ff_expert or cfg.d_ff)
    return router + experts


def _ssd_flops(cfg, B: int, S: int) -> float:
    s = cfg.ssm
    d = cfg.d_model
    di = s.expand * d
    nh = di // s.head_dim
    G, N, Pd, Q = s.n_groups, s.state_dim, s.head_dim, s.chunk
    T = B * S
    nc = max(S // Q, 1)
    proj = 2.0 * T * d * (2 * di + 2 * G * N + nh) + 2.0 * T * di * d
    conv = 2.0 * T * (di + 2 * G * N) * s.conv_width
    intra = 2.0 * B * nc * Q * Q * G * (N + (nh // G) * Pd)
    states = 2.0 * T * nh * Pd * N * 2.0       # states + y_off
    return proj + conv + intra + states


def forward_flops(cfg, B: int, S: int) -> float:
    """Exact matmul FLOPs of one forward pass (global, all layers)."""
    d, V = cfg.d_model, cfg.vocab
    total = 2.0 * B * S * d * V                 # unembed
    fam = cfg.family
    if fam in ("dense", "vlm", "moe"):
        from ..models.transformer import layer_pattern
        pat = layer_pattern(cfg)
        reps = cfg.n_layers // len(pat)
        for kind in pat:
            w = cfg.local_window if kind == "local" else (
                cfg.window if kind == "window" else 0)
            ctx = _avg_causal_ctx(S, w)
            total += reps * _attn_layer_flops(cfg, B, S, ctx)
            if fam == "moe":
                total += reps * _moe_flops(cfg, B, S)
            else:
                total += reps * _mlp_flops(B, S, d, cfg.d_ff)
        if fam == "vlm" and cfg.vision is not None:
            total += 2.0 * B * cfg.vision.n_patches * cfg.vision.patch_dim * d
    elif fam == "ssm":
        total += cfg.n_layers * _ssd_flops(cfg, B, S)
    elif fam == "hybrid":
        total += cfg.n_layers * _ssd_flops(cfg, B, S)
        if cfg.hybrid is not None and cfg.hybrid.shared_attn:
            g = cfg.n_layers // cfg.hybrid.attn_every
            ctx = _avg_causal_ctx(S, 0)
            total += g * (_attn_layer_flops(cfg, B, S, ctx)
                          + _mlp_flops(B, S, d, cfg.d_ff))
    elif fam == "audio":
        e = cfg.encdec
        F = e.n_frames
        ctx_enc = float(F)                       # bidirectional
        total += e.n_encoder_layers * (
            _attn_layer_flops(cfg, B, F, ctx_enc) + _mlp_flops(B, F, d, cfg.d_ff))
        ctx_dec = _avg_causal_ctx(S, 0)
        cross = (2.0 * B * S * d * cfg.n_heads * cfg.head_dim_      # q
                 + 2.0 * B * F * d * 2 * cfg.n_kv_heads * cfg.head_dim_
                 + 2.0 * B * cfg.n_heads * S * F * cfg.head_dim_ * 2.0
                 + 2.0 * B * S * cfg.n_heads * cfg.head_dim_ * d)
        total += cfg.n_layers * (
            _attn_layer_flops(cfg, B, S, ctx_dec) + cross
            + _mlp_flops(B, S, d, cfg.d_ff))
    else:
        raise ValueError(fam)
    return total


def decode_flops(cfg, B: int, kv_len: int) -> float:
    """One decode step: weights-dense part + attention against the cache."""
    d, V = cfg.d_model, cfg.vocab
    total = 2.0 * B * d * V
    fam = cfg.family

    def attn_ctx(w):
        return min(kv_len, w) if w > 0 else kv_len

    if fam in ("dense", "vlm", "moe"):
        from ..models.transformer import layer_pattern
        pat = layer_pattern(cfg)
        reps = cfg.n_layers // len(pat)
        for kind in pat:
            w = cfg.local_window if kind == "local" else (
                cfg.window if kind == "window" else 0)
            total += reps * (_attn_layer_flops(cfg, B, 1, attn_ctx(w)))
            if fam == "moe":
                total += reps * _moe_flops(cfg, B, 1)
            else:
                total += reps * _mlp_flops(B, 1, d, cfg.d_ff)
    elif fam == "ssm":
        total += cfg.n_layers * _ssd_decode_flops(cfg, B)
    elif fam == "hybrid":
        total += cfg.n_layers * _ssd_decode_flops(cfg, B)
        if cfg.hybrid is not None and cfg.hybrid.shared_attn:
            g = cfg.n_layers // cfg.hybrid.attn_every
            total += g * (_attn_layer_flops(cfg, B, 1, kv_len)
                          + _mlp_flops(B, 1, d, cfg.d_ff))
    elif fam == "audio":
        e = cfg.encdec
        cross = 2.0 * B * cfg.n_heads * e.n_frames * cfg.head_dim_ * 2.0
        total += cfg.n_layers * (_attn_layer_flops(cfg, B, 1, kv_len) + cross
                                 + _mlp_flops(B, 1, d, cfg.d_ff))
    return total


def _ssd_decode_flops(cfg, B: int) -> float:
    s = cfg.ssm
    d = cfg.d_model
    di = s.expand * d
    nh = di // s.head_dim
    G, N, Pd = s.n_groups, s.state_dim, s.head_dim
    proj = 2.0 * B * d * (2 * di + 2 * G * N + nh) + 2.0 * B * di * d
    state = 4.0 * B * nh * Pd * N            # h update + C·h
    return proj + state + 2.0 * B * (di + 2 * G * N) * s.conv_width


@dataclass
class AnalyticCell:
    flops_global: float
    bytes_global: float
    flops_per_device: float
    bytes_per_device: float
    assumptions: str


def analytic_cell(cfg, shape, *, chips: int, n_micro: int = 1,
                  param_bytes: Optional[int] = None,
                  cache_bytes: Optional[int] = None,
                  remat: bool = True,
                  attention_impl: str = "naive") -> AnalyticCell:
    """FLOPs exact; bytes = weights traffic + activation/cache traffic.

    Byte-model assumptions:
      * train reads every weight 3x per microbatch (fwd, remat recompute,
        bwd) and touches grads (rw, f32) once per microbatch; optimizer
        state rw once per step (ZeRO-1 sharded);
      * activation traffic ≈ (6·d + 4·ff_eff)·2B per token·layer (residual
        stream + mlp intermediates, read+write);
      * ``naive`` attention materialises S×ctx scores twice (f32 softmax
        in/out), the plain attention; ``flash`` drops the S² traffic;
      * decode reads all weights + the whole KV cache once per step.
    """
    B, S = shape.global_batch, shape.seq_len
    d = cfg.d_model
    pb = param_bytes if param_bytes is not None else cfg.param_count() * 2
    L = max(cfg.n_layers, 1)
    ff_eff = cfg.d_ff if cfg.family != "moe" else (
        cfg.moe.top_k * (cfg.moe.d_ff_expert or cfg.d_ff))
    if cfg.family in ("ssm", "hybrid"):
        ff_eff = 2 * cfg.ssm.expand * d

    if shape.kind == "train":
        fwd = forward_flops(cfg, B, S)
        mult = 4.0 if remat else 3.0       # fwd + (recompute) + 2x bwd
        flops = fwd * mult + 20.0 * cfg.param_count()
        weight_traffic = pb * 3.0 * n_micro
        grads = cfg.param_count() * 4 * 2 * n_micro
        opt = cfg.param_count() * 4 * 7
        act = B * S * (6 * d + 4 * ff_eff) * 2 * L * (2.0 if remat else 1.0)
        attn_traffic = 0.0
        if attention_impl == "naive" and cfg.family not in ("ssm",):
            ctx = _avg_causal_ctx(S, cfg.window or 0)
            n_attn = L if cfg.family != "hybrid" else (
                L // cfg.hybrid.attn_every)
            attn_traffic = 8.0 * B * cfg.n_heads * S * ctx * n_attn * 2.0
        logits = B * S * cfg.vocab * 4 * 3.0 / n_micro  # per-micro ce
        byts = weight_traffic + grads + opt + act + attn_traffic + logits
    elif shape.kind == "prefill":
        flops = forward_flops(cfg, B, S)
        act = B * S * (6 * d + 4 * ff_eff) * 2 * L
        attn_traffic = 0.0
        if attention_impl == "naive" and cfg.family not in ("ssm",):
            ctx = _avg_causal_ctx(S, cfg.window or 0)
            n_attn = L if cfg.family != "hybrid" else (
                L // cfg.hybrid.attn_every)
            attn_traffic = 8.0 * B * cfg.n_heads * S * ctx * n_attn
        byts = pb + act + attn_traffic
    else:  # decode
        flops = decode_flops(cfg, B, S)
        cb = cache_bytes if cache_bytes is not None else 0
        byts = pb + cb + B * d * 2 * L * 8
    return AnalyticCell(
        flops_global=flops,
        bytes_global=byts,
        flops_per_device=flops / chips,
        bytes_per_device=byts / chips,
        assumptions=f"remat={remat} n_micro={n_micro} attn={attention_impl}",
    )
