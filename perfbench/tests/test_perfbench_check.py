"""CPU tests of what decides ``correct``: the reference against the
program's plain CPU path (capacity drops included), whole runs of each
cell at the configurations' smoke sizes with the timed path broken
underneath, and the float8 control."""
from __future__ import annotations

import itertools

import pytest
import torch

from perfbench import common, weights
from perfbench.arch import arch
from perfbench.families import moe
from perfbench.families.moe import block, capacity
from perfbench.reference import serve as ref_serve
from perfbench.reference.model import Prec, unembed
from perfbench.run import program_for, run_workload

SEED = 2**33 + 17
TRAIN = "train.qwen3-moe-30b-a3b.4k"
CHAT = "serve.mixtral-8x22b.chat"
BATCH = "serve.mixtral-8x22b.batch"


def _program_f32(name):
    from repro_torch.models.model import Model
    a, cfg = program_for(name, smoke=True)
    model = Model(cfg.scaled(param_dtype="float32"), "cpu")
    params = weights.program_params(a, model.param_specs(), SEED, "cpu")
    f32 = lambda t: {k: f32(v) for k, v in t.items()} if isinstance(t, dict) else t.float()  # noqa: E731
    return a, model, f32(params)


def test_reference_forward_equals_the_program_past_the_no_drop_size(monkeypatch):
    """One call of 300 > 256 tokens, its first 150 the same token: their
    MoE inputs are alike in the first layer, so their experts overflow the
    capacity (94) and the (t, k) order decides which choices are dropped."""
    a, model, params = _program_f32("qwen3-moe-30b-a3b")
    S = 300
    tokens = torch.randint(0, a.vocab, (1, S), generator=torch.Generator().manual_seed(3))
    tokens[0, :150] = 7
    logits, _ = model.logits(params, {"tokens": tokens}, remat="none")
    dropped, route = [], moe.route

    def counted(*args):
        out = route(*args)
        dropped.append(int((~out[2]).sum()))
        return out
    monkeypatch.setattr(moe, "route", counted)
    x = weights.make(SEED, "embed/table", None, (a.vocab, a.d), "cpu").float()[tokens]
    pos = torch.arange(S)
    for layer in range(a.n_layers):
        w = {k: v.float() for k, v in weights.layer_leaves(a, SEED, layer, "cpu").items()}
        x, _ = block(x, w, a, pos, [(0, S, True)], Prec())
    ref = unembed(x[0], weights.make(SEED, "final_norm", None, (a.d,), "cpu"),
                  weights.make(SEED, "lm_head", None, (a.d, a.vocab), "cpu"), a.eps, Prec())
    assert capacity(S, a) == 94 and dropped[0] > 0
    torch.testing.assert_close(logits[0], ref, rtol=2e-4, atol=2e-4)


def test_reference_reads_served_tokens_of_the_batcher_as_its_own():
    """Prefill of a 299-token prompt (capacity drops) into a slot of the
    batcher, decode through the cache (a ring of 64 window slots): in f32
    the served tokens are the reference's greedy ones."""
    from repro_torch.runtime.serve import ContinuousBatcher, Request
    a, model, params = _program_f32("mixtral-8x22b")
    b = ContinuousBatcher(model, params, 2, 512, eos_token=-1)
    g = torch.Generator().manual_seed(5)
    reqs = [Request(str(i), torch.randint(0, a.vocab, (n,), generator=g).tolist(), 20)
            for i, n in enumerate((300, 40))]
    for r in reqs:
        b.submit(r)
    b.drain()
    assert capacity(299, a) < 299
    r = ref_serve.gaps(a, SEED, [(q.prompt, q.tokens_out) for q in reqs], "cpu")
    assert r["tokens"] == 40
    assert r["gap"] < 1e-4


def _faults():
    """(name, patcher): each breaks the timed path underneath the harness."""
    from repro_torch.models import transformer
    from repro_torch.optim import adamw
    from repro_torch.runtime import serve

    def unchanged_train(mp):
        def update(self, grads, state, params):
            lead = adamw.tree_leaves(grads)
            gnorm = adamw.global_norm([g.float() for g in lead])
            return params, adamw.AdamWState(state.step + 1, state.master, state.m, state.v), {
                "grad_norm": gnorm, "lr": self.lr(state.step + 1)}
        mp.setattr(adamw.AdamW, "update", update)

    def microbatch_left_out(mp):
        from repro_torch.models.model import Model
        loss, calls = Model.loss, itertools.count()

        def first_only(self, params, batch, remat="block"):
            # of a step's two microbatches the second is left out and the
            # mean taken over the first: its loss counted twice, the other's 0
            value, metrics = loss(self, params, batch, remat)
            return value * (2.0 if next(calls) % 2 == 0 else 0.0), metrics
        mp.setattr(Model, "loss", first_only)

    def unchanged_cache(mp):
        from repro_torch.kernels import ops

        def attend(q, k, v, kc, vc, at):            # the step's K/V never written
            return ops.flash_attention_fwd(q, kc, vc, causal=False, window=0, kv_len=at[2])[0]
        mp.setattr(transformer, "attend_cached", attend)

    def half_batch_serve(mp):
        moe_ffn = transformer.moe_ffn

        def half(x, p, moe):
            y, aux = moe_ffn(x, p, moe)
            y = y.clone()
            if x.shape[0] > 1:
                y[x.shape[0] // 2:] = 0
            else:
                y[:, x.shape[1] // 2:] = 0
            return y, aux
        mp.setattr(transformer, "moe_ffn", half)

    def altered_token(mp):
        step = serve.ContinuousBatcher.step

        def altered(self):
            n = step(self)
            for r in self.slots:
                if r is not None and len(r.tokens_out) == 3:
                    r.tokens_out[-1] = (r.tokens_out[-1] + 1) % self.model.cfg.vocab
            return n
        mp.setattr(serve.ContinuousBatcher, "step", altered)

    return {TRAIN: {"state unchanged": unchanged_train, "half the batch": microbatch_left_out},
            CHAT: {"state unchanged": unchanged_cache, "half the batch": half_batch_serve,
                   "token altered": altered_token},
            BATCH: {"state unchanged": unchanged_cache, "half the batch": half_batch_serve,
                    "token altered": altered_token}}


@pytest.mark.parametrize("cell", [TRAIN, CHAT, BATCH])
def test_sound_run_is_correct_and_each_fault_is_not(cell, monkeypatch):
    seconds = 1.0 if cell == TRAIN else 3.0           # long enough to finish requests
    sound = run_workload(cell, SEED, seconds, False, device="cpu", smoke=True)
    assert sound["correct"], sound["checks"]
    assert sound["metrics"]["setup_s"]["value"] > 0
    for fault, patch in _faults()[cell].items():
        with monkeypatch.context() as mp:
            patch(mp)
            broken = run_workload(cell, SEED, seconds, False, device="cpu", smoke=True)
        assert not broken["correct"], (fault, broken["checks"])


def test_the_control_reads_above_the_program():
    """The float8 control, at the same places as a bf16 program's served
    tokens, reads a wider gap than the program (CPU, smoke size)."""
    from repro_torch.models.model import Model
    from repro_torch.runtime.serve import ContinuousBatcher, Request
    a, cfg = program_for("mixtral-8x22b", smoke=True)
    worst_prog, least_ctl = 0.0, float("inf")
    for seed in (1, 2, 3):
        model = Model(cfg, "cpu")
        params = weights.program_params(a, model.param_specs(), seed, "cpu")
        b = ContinuousBatcher(model, params, 2, 512, eos_token=-1)
        g = torch.Generator().manual_seed(seed)
        reqs = [Request(str(i), torch.randint(0, a.vocab, (n,), generator=g).tolist(), 48)
                for i, n in enumerate((280, 60))]
        for r in reqs:
            b.submit(r)
        b.drain()
        r = ref_serve.gaps(a, seed, [(q.prompt, q.tokens_out) for q in reqs], "cpu",
                           control=Prec("fp8"))
        worst_prog, least_ctl = max(worst_prog, r["gap"]), min(least_ctl, r["gap_control"])
    assert least_ctl > worst_prog


def test_the_control_reads_above_the_program_in_training():
    """The number that the float8 control fails in the train cell, the
    output head's first-gradient gap, read on the head alone at a size a
    test holds (1,024 tokens of RMSNorm'd states, d 512, a vocabulary of
    65,536, random labels): the control's product reads at least three
    times what bf16 operands (the program's precision) read."""
    from perfbench.reference.model import rmsnorm, strict_f32

    class Bf16:
        def mm(self, a, b):
            return a.to(torch.bfloat16).float() @ b.to(torch.bfloat16).float()

    strict_f32()
    N, d, V = 1024, 512, 65536
    for seed in (1, 2):
        g = torch.Generator().manual_seed(seed)
        h = rmsnorm(torch.randn(N, d, generator=g), 1 + 0.1 * torch.randn(d, generator=g), 1e-6)
        w = torch.randn(d, V, generator=g) / d ** 0.5
        labels = torch.randint(0, V, (N,), generator=g)

        def head_grad_norm(prec):
            leaf = w.clone().requires_grad_(True)
            logits = prec.mm(h, leaf)
            (torch.logsumexp(logits, -1) - logits.gather(1, labels[:, None])[:, 0]).mean().backward()
            return float(leaf.grad.norm())

        ref = head_grad_norm(Prec("f32"))
        control = abs(head_grad_norm(Prec("fp8")) - ref) / ref
        bf16 = abs(head_grad_norm(Bf16()) - ref) / ref
        assert control > 3 * bf16, (control, bf16)
