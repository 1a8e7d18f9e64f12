"""The reference's reading of served requests: each prompt with its served
tokens run through the model once, layer by layer over all the sampled
requests (each layer's weights made again from the seed, then freed), and
every served token's gap below the reference's best logit at its place."""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from .. import weights
from ..arch import Arch
from ..families import family
from .model import Prec, served_segments, unembed


@torch.no_grad()
def gaps(a: Arch, seed: int, served: Sequence[Tuple[List[int], List[int]]], device: Any,
         control: Optional[Prec] = None) -> Dict[str, Any]:
    """``served``: (prompt, served tokens) pairs. The reference's input is
    prompt + served[:-1]; its logits from position len(prompt) - 1 on
    predict the served tokens. → the gaps of the served tokens below the
    reference's best at their places (``_summary``), and with ``control``
    the same of the tokens the control puts first there (keys ending in
    ``_control``)."""
    ref, ctl = Prec("f32"), control
    block = family(a.family).block
    seqs = []
    for prompt, out in served:
        toks = torch.tensor(prompt + out[:-1], device=device)
        seqs.append((len(prompt), toks, out))
    table = weights.make(seed, "embed/table", None, (a.vocab, a.d), device)
    xs = [table[t].float()[None] for _, t, _ in seqs]
    xc = [x.clone() for x in xs] if ctl else None
    del table
    for layer in range(a.n_layers):
        w = weights.layer_leaves(a, seed, layer, device)
        for i, (P, toks, _) in enumerate(seqs):
            pos = torch.arange(toks.shape[0], device=device)
            segs = served_segments(P, toks.shape[0])
            xs[i] = block(xs[i], w, a, pos, segs, ref)[0]
            if ctl:
                xc[i] = block(xc[i], w, a, pos, segs, ctl)[0]
        del w
    fn = weights.make(seed, "final_norm", None, (a.d,), device)
    head = weights.make(seed, "lm_head", None, (a.d, a.vocab), device)
    prog_gaps, ctl_gaps = [], []
    for i, (P, toks, out) in enumerate(seqs):
        lg = unembed(xs[i][0, P - 1:], fn, head, a.eps, ref)                # (len(out), V)
        best = lg.max(-1).values
        served_t = torch.tensor(out, device=device)
        prog_gaps.append(best - lg.gather(1, served_t[:, None])[:, 0])
        if ctl:
            pick = unembed(xc[i][0, P - 1:], fn, head, a.eps, ctl).argmax(-1)
            ctl_gaps.append(best - lg.gather(1, pick[:, None])[:, 0])
    res = _summary(torch.cat(prog_gaps), "")
    if ctl:
        res.update(_summary(torch.cat(ctl_gaps), "_control"))
    return res


def _summary(g: torch.Tensor, tag: str) -> Dict[str, Any]:
    """The widest and the mean gap, how many tokens, and the share of
    tokens that were not the reference's best."""
    return {f"gap{tag}": float(g.max()), f"mean_gap{tag}": float(g.mean()),
            f"tokens{tag}": int(g.numel()), f"off_best{tag}": float((g > 0).float().mean())}
