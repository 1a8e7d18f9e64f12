"""Logical-axis sharding rules (port of ``repro.runtime.sharding``), placed
with DTensor.

Every parameter, cache and input dim carries a *logical* axis name; rules
map logical axes to mesh axes per (shape kind × mesh). A mesh axis is
applied only when the dim's size divides by the extent so far times the
axis's, and only if no other dim of the same tensor took it, so one rule
table serves all ten architectures (whisper's vocab 51865 does not divide
by 16 and replicates; gemma's 262144 shards). The rules, ``spec_for``,
``cache_axes`` and ``input_axes`` are ``repro``'s, line for line.

``spec_for`` reads the mesh only as a mapping of axis name to extent
(``axis_sizes``), so it takes a ``DeviceMesh``, a plain dict or anything
whose ``shape`` is such a mapping. It returns the port's ``PartitionSpec``:
per tensor dim, a mesh-axis name, a tuple of them, or ``None``.
``placements`` (``repro_torch.shards``) turns a spec into DTensor
placements, one per mesh dim.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Tuple

import torch
from torch.distributed.tensor import DTensor, distribute_tensor

from ..shards import AxisAssign, _as_tuple, place, placements

Rules = Dict[Optional[str], AxisAssign]


class PartitionSpec(tuple):
    """Per tensor dim: a mesh-axis name, a tuple of names, or ``None``."""

    def __new__(cls, *entries: AxisAssign) -> "PartitionSpec":
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


def axis_sizes(mesh: Any) -> Mapping[str, int]:
    """Axis name → extent, of a ``DeviceMesh`` or of a mesh-like whose
    ``shape`` is already that mapping (or of the mapping itself)."""
    if isinstance(mesh, Mapping):
        return mesh
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return mesh.shape


def base_rules(multi_pod: bool, family: str = "dense") -> Rules:
    """Default parameter rules: TP over "model", DP/ZeRO over data axes.

    MoE expert weights dominate parameter bytes (mixtral: 264 of 280 GB):
    model-axis TP alone leaves > 17 GB a device, so their hidden dim
    shards over the data axes too (2-D weight sharding)."""
    ff: AxisAssign = "model"
    if family == "moe":
        ff = ("pod", "data", "model") if multi_pod else ("data", "model")
    return {
        "vocab": "model",
        "heads": "model",
        "kv_heads": "model",
        "ff": ff,
        "experts": None,            # EP variant applied by decode_rules
        "ssm_inner": "model",
        "embed": None,
        "layers": None,
        "pattern": None,
        None: None,
    }


def batch_axes(multi_pod: bool) -> Tuple[str, ...]:
    return ("pod", "data") if multi_pod else ("data",)


def decode_rules(multi_pod: bool, long_context: bool,
                 family: str = "dense", n_experts: int = 0) -> Rules:
    """Cache/activation rules for serving cells. MoE decode uses expert
    parallelism from 64 experts on (``repro``'s measured choice; mixtral's
    8 experts keep the 2-D ff sharding)."""
    r = base_rules(multi_pod, family)
    if family == "moe" and n_experts >= 64:
        r["experts"] = ("pod", "data") if multi_pod else ("data",)
    r.update({
        "batch": batch_axes(multi_pod),
        # long context (batch 1): spread KV slots over everything; normal
        # decode: batch over the data axes, slots over model
        "kv_seq": (("pod", "data", "model") if multi_pod else ("data", "model"))
        if long_context else "model",
        "kv_heads_cache": None,
        "ssm_heads": "model",
    })
    return r


def train_rules(multi_pod: bool, family: str = "dense") -> Rules:
    r = base_rules(multi_pod, family)
    r.update({"batch": batch_axes(multi_pod)})
    return r


def spec_for(shape: Sequence[int], axes: Sequence[Optional[str]],
             rules: Rules, mesh: Any) -> PartitionSpec:
    """One tensor's spec, with divisibility degradation and no axis reuse."""
    sizes = axis_sizes(mesh)
    used: set = set()
    out = []
    for size, logical in zip(shape, axes):
        cands = _as_tuple(rules.get(logical, None))
        take = []
        ext = 1
        for ax in cands:
            if ax in used or ax not in sizes:
                continue
            e = sizes[ax]
            if size % (ext * e) == 0:
                take.append(ax)
                ext *= e
        for ax in take:
            used.add(ax)
        out.append(tuple(take) if len(take) > 1 else (take[0] if take else None))
    return PartitionSpec(*out)


@dataclass(frozen=True)
class NamedSharding:
    """A mesh and one tensor's placements on it (with the spec they came
    from): what ``jax.sharding.NamedSharding`` is to ``repro``."""
    mesh: Any
    placements: Tuple[Any, ...]
    spec: PartitionSpec = PartitionSpec()

    @classmethod
    def of(cls, mesh: Any, spec: Sequence[AxisAssign]) -> "NamedSharding":
        return cls(mesh, placements(spec, mesh), PartitionSpec(*spec))


def replicated(mesh: Any) -> NamedSharding:
    return NamedSharding.of(mesh, PartitionSpec())


# ---------------------------------------------------------------------------
# trees: nested dicts, NamedTuples, tuples and lists with tensors at the
# leaves (an axes tree has tuple leaves, matched up to the tensor tree's
# structure)
# ---------------------------------------------------------------------------
def map_tree(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """``tree`` rebuilt with ``fn(leaf, *matching leaves of rest)``; the
    other trees are read up to ``tree``'s structure (so an axes tree's tuple
    leaves stay whole)."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (tuple, list)):
        out = [map_tree(fn, t, *(r[i] for r in rest)) for i, t in enumerate(tree)]
        return type(tree)(*out) if hasattr(tree, "_fields") else type(tree)(out)
    return fn(tree, *rest)


def shardings_for_tree(shapes_tree: Any, axes_tree: Any, rules: Rules,
                       mesh: Any) -> Any:
    """A ``NamedSharding`` per tensor of ``shapes_tree`` (``meta`` ones
    included), from the matching leaf of ``axes_tree``."""
    return map_tree(lambda s, a: NamedSharding.of(mesh, spec_for(s.shape, a, rules, mesh)),
                    shapes_tree, axes_tree)


def shard_tree(tree: Any, shardings: Any) -> Any:
    """Place every tensor of ``tree`` (the full value, the same on every
    rank) onto its sharding with ``distribute_tensor``; a DTensor is
    redistributed there instead (the elastic path)."""

    def one(t: torch.Tensor, sh: NamedSharding) -> DTensor:
        if isinstance(t, DTensor):
            if t.device_mesh == sh.mesh:
                return place(t, sh.placements)
            t = t.full_tensor()
        return distribute_tensor(t.detach(), sh.mesh, sh.placements)

    return map_tree(one, tree, shardings)


def unshard_tree(tree: Any) -> Any:
    """Every DTensor of ``tree`` as its full tensor (plain tensors stay)."""
    return map_tree(lambda t: t.full_tensor() if isinstance(t, DTensor) else t, tree)


# ---------------------------------------------------------------------------
# cache logical axes per family (parallel to the models' cache_shapes)
# ---------------------------------------------------------------------------
def cache_axes(cfg) -> Dict[str, Any]:
    if cfg.family in ("dense", "moe", "vlm"):
        kinds = {}
        from ..models.transformer import layer_pattern
        pat = layer_pattern(cfg)
        for kind in set(pat):
            kinds[kind] = {
                "k": (None, None, "batch", "kv_seq", "kv_heads_cache", None),
                "v": (None, None, "batch", "kv_seq", "kv_heads_cache", None),
            }
        return kinds
    if cfg.family == "ssm":
        return {"conv": (None, "batch", None, "ssm_inner"),
                "ssm": (None, "batch", "ssm_heads", None, None)}
    if cfg.family == "hybrid":
        axes = {"conv": (None, None, "batch", None, "ssm_inner"),
                "ssm": (None, None, "batch", "ssm_heads", None, None)}
        if cfg.hybrid is not None and cfg.hybrid.shared_attn:
            axes["attn_k"] = (None, "batch", "kv_seq", "kv_heads_cache", None)
            axes["attn_v"] = (None, "batch", "kv_seq", "kv_heads_cache", None)
        return axes
    if cfg.family == "audio":
        a = (None, "batch", "kv_seq", "kv_heads_cache", None)
        return {"self_k": a, "self_v": a,
                "cross_k": (None, "batch", None, "kv_heads_cache", None),
                "cross_v": (None, "batch", None, "kv_heads_cache", None)}
    raise ValueError(cfg.family)


def input_axes(cfg, kind: str) -> Dict[str, Any]:
    """Logical axes for the ``input_specs()`` trees."""
    if kind in ("train", "prefill"):
        ax: Dict[str, Any] = {"tokens": ("batch", None)}
        if kind == "train":
            ax["labels"] = ("batch", None)
        if cfg.family == "vlm":
            ax["patches"] = ("batch", None, None)
        if cfg.family == "audio":
            ax["frames"] = ("batch", None, None)
        return ax
    return {"cache": cache_axes(cfg),
            "token": ("batch",),
            "pos": ()}
