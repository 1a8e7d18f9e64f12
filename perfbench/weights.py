"""Weights made from ``--seed`` on the device, in the type they are served
and trained in (bf16), one generator call a leaf and layer.

Each (leaf, layer) draws from its own seed (``sub_seed``), so the program
gets its stacked tensors and the reference can make any one layer again,
alone, with the same values. Matrices are normal with std 1/sqrt(fan-in)
(fan-in: the second-to-last dim); norm scales are normal about 1 with std
0.1, so that a scale left out shows.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from .arch import Arch
from .common import sub_seed
from .families import family

DTYPE = torch.bfloat16


def leaves(a: Arch) -> List[Tuple[str, Tuple[int, ...], bool]]:
    """(name, shape of one layer's leaf, whether it is per layer) of every
    leaf of the family's model, named by the program's key paths."""
    return family(a.family).leaves(a)


def leaf_key(name: str, layer: Optional[int]) -> str:
    return name if layer is None else f"{name}[{layer}]"


def make(seed: int, name: str, layer: Optional[int], shape: Tuple[int, ...],
         device: Any) -> torch.Tensor:
    """One leaf of one layer (``layer`` None: a leaf outside the layers)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, f"weights/{leaf_key(name, layer)}"))
    out = torch.empty(shape, dtype=DTYPE, device=device)
    if len(shape) == 1:
        return out.normal_(1.0, 0.1, generator=gen)
    return out.normal_(0.0, shape[-2] ** -0.5, generator=gen)


def layer_leaves(a: Arch, seed: int, layer: int, device: Any) -> Dict[str, torch.Tensor]:
    """Every per-layer leaf of ``layer``, by name."""
    return {n: make(seed, n, layer, s, device) for n, s, per in leaves(a) if per}


def program_params(a: Arch, specs: Dict[str, Any], seed: int, device: Any) -> Dict[str, Any]:
    """The program's parameter tree, shaped as ``specs`` (its tensors on
    ``meta``), filled leaf by leaf and layer by layer. A stacked leaf is
    (groups, pattern, *one layer's shape), layer = group · pattern + index.
    Raises where the program's tree and ``leaves(a)`` disagree."""
    want = {n: (s, per) for n, s, per in leaves(a)}
    out: Dict[str, Any] = {}
    seen = set()

    def walk(tree: Dict[str, Any], dst: Dict[str, Any], prefix: str) -> None:
        for k, v in tree.items():
            path = f"{prefix}{k}"
            if isinstance(v, dict):
                dst[k] = {}
                walk(v, dst[k], path + "/")
                continue
            if path not in want:
                raise ValueError(f"the program has a leaf {path!r} the benchmark does not make")
            shape, per = want[path]
            seen.add(path)
            if not per:
                if tuple(v.shape) != shape:
                    raise ValueError(f"{path}: program {tuple(v.shape)}, benchmark {shape}")
                dst[k] = make(seed, path, None, shape, device)
                continue
            g, pat = v.shape[:2]
            if tuple(v.shape[2:]) != shape or g * pat != a.n_layers:
                raise ValueError(f"{path}: program {tuple(v.shape)}, benchmark "
                                 f"{a.n_layers} layers of {shape}")
            t = torch.empty(tuple(v.shape), dtype=DTYPE, device=device)
            for layer in range(g * pat):
                t[layer // pat, layer % pat].copy_(make(seed, path, layer, shape, device))
            dst[k] = t

    walk(specs, out, "")
    missing = set(want) - seen
    if missing:
        raise ValueError(f"the program's tree lacks {sorted(missing)}")
    return out


def program_leaf_views(params: Dict[str, Any], a: Arch) -> Dict[str, torch.Tensor]:
    """The program's tree (params, master or a moment) as one tensor per
    (leaf, layer), keyed by ``leaf_key``: views, no copies."""
    out = {}
    for name, _, per in leaves(a):
        t = params
        for part in name.split("/"):
            t = t[part]
        if not per:
            out[leaf_key(name, None)] = t
            continue
        pat = t.shape[1]
        for layer in range(a.n_layers):
            out[leaf_key(name, layer)] = t[layer // pat, layer % pat]
    return out
