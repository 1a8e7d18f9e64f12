"""DTensor helpers of the kernel entry points and the model code: where a
rank's shard lies, in plain integers (a KV head range, a vocab offset, a
cache slot range; DTensor's own helper reads the mesh coordinate through
tensors, which fails while a step is traced under ``FakeTensorMode``), and
``place``, each explicit redistribution of the port; ``placements``, a
spec's DTensor placements; ``prefill_rows``, the cache rows a prefill
writes."""
from __future__ import annotations

from typing import Any, Sequence, Tuple, Union

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

# one tensor dim's assignment: None, a mesh-axis name, or a tuple of them
AxisAssign = Union[None, str, Tuple[str, ...]]


def _as_tuple(a: AxisAssign) -> Tuple[str, ...]:
    if a is None:
        return ()
    if isinstance(a, str):
        return (a,)
    return tuple(a)


def placements(spec: Sequence[AxisAssign], mesh: Any) -> Tuple[Any, ...]:
    """DTensor placements of ``spec`` on ``mesh``: per mesh dim, ``Shard(d)``
    if tensor dim ``d`` names that axis, else ``Replicate()``. A dim split
    over several axes must name them in mesh order (major to minor)."""
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        axes = _as_tuple(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"dim {d} of {spec}: axes {axes} are not in mesh order {names}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def prefill_rows(x: torch.Tensor, row: int) -> slice:
    """The cache rows a prefill of x's batch from ``row`` writes; a sharded
    cache (a mesh's prefill) is written whole, from row 0."""
    if isinstance(x, DTensor):
        if row != 0:
            raise ValueError("a sharded cache is prefilled from row 0, every row at once")
        return slice(None)
    return slice(row, row + x.shape[0])


def place(x: DTensor, placements: Sequence[Any]) -> DTensor:
    """x redistributed to ``placements`` on its mesh (x itself when it is
    placed so already)."""
    placements = tuple(placements)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(x.device_mesh, placements)


def local_shape_and_offset(shape: Sequence[int], mesh: Any, placements: Sequence[Any],
                           ) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """This rank's shard of a tensor of ``shape`` at ``placements``: → (its
    shape, its offset in the whole tensor). ``torch.chunk``'s split (ceil
    chunks, the last ones short), mesh dims applied in order, as DTensor
    splits; computed from the rank's mesh coordinate in plain integers, so
    it also runs under ``FakeTensorMode``."""
    size, off = list(shape), [0] * len(shape)
    coord = mesh.get_coordinate()
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            d, n = p.dim, mesh.shape[i]
            chunk = -(-size[d] // n)
            start = min(coord[i] * chunk, size[d])
            off[d] += start
            size[d] = max(0, min(chunk, size[d] - start))
    return tuple(size), tuple(off)
