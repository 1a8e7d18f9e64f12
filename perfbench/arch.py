"""A configuration file read as the numbers the reference, the weights and
the counts need, held against the program's own config, and the program's
config set as the file states it.

The files under ``configs/`` use the published ``config.json`` keys, with
the values as they are run, and name their model ``family``: what belongs
to one family (its sizes, leaves, reference layer, counts) is
``families/<family>.py``. ``smoke`` replaces some keys for the CPU tests.
Nothing here imports the program: the caller hands over its config.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List

from .families import family


@dataclass(frozen=True)
class Arch:
    """What every family has; a family's own ``Arch`` adds its sizes."""
    name: str
    family: str
    d: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    vocab: int
    rope_theta: float
    eps: float
    window: int


def arch(cfg: Dict[str, Any], smoke: bool = False) -> Arch:
    c = {**cfg, **(cfg.get("smoke", {}) if smoke else {})}
    heads = c["num_attention_heads"]
    common = dict(
        name=c["name"], family=c["family"], d=c["hidden_size"], n_layers=c["num_hidden_layers"],
        n_heads=heads, n_kv_heads=c["num_key_value_heads"],
        head_dim=c.get("head_dim") or c["hidden_size"] // heads,
        vocab=c["vocab_size"], rope_theta=float(c["rope_theta"]),
        eps=float(c["rms_norm_eps"]), window=int(c.get("sliding_window") or 0))
    return family(c["family"]).arch(c, common)


def program_mismatches(a: Arch, program_cfg: Any) -> List[str]:
    """Every width and structural switch on which the program's config (a
    ``ModelConfig``, as ``get_config`` gives it) differs from the file.
    Depth, norm epsilon, window and loss weights are not compared: the
    harness sets them (``program_config``)."""
    pairs = {
        "family": (a.family, program_cfg.family),
        "hidden_size": (a.d, program_cfg.d_model),
        "num_attention_heads": (a.n_heads, program_cfg.n_heads),
        "num_key_value_heads": (a.n_kv_heads, program_cfg.n_kv_heads),
        "head_dim": (a.head_dim, program_cfg.head_dim_),
        "vocab_size": (a.vocab, program_cfg.vocab),
        "rope_theta": (a.rope_theta, float(program_cfg.rope_theta)),
        "rope_fraction": (1.0, program_cfg.rope_fraction),
        "qkv_bias": (False, program_cfg.qkv_bias),
        "tie_word_embeddings": (False, program_cfg.tie_embeddings),
        "local_global": (0, program_cfg.local_global),
        **family(a.family).mismatches(a, program_cfg),
    }
    return [f"{k}: file {f!r}, program {p!r}" for k, (f, p) in pairs.items() if f != p]


def program_config(a: Arch, program_cfg: Any) -> Any:
    """The program's config run as the file states it: its depth, norm
    epsilon and window, and what the family sets."""
    cfg = program_cfg.scaled(n_layers=a.n_layers, norm_eps=a.eps, window=a.window)
    return family(a.family).program_config(a, cfg)
