"""CPU tests of the benchmark's parts: traffic, configurations, counts,
readers, the import rule."""
from __future__ import annotations

import re
import subprocess
import sys
from collections import Counter

import pytest

from perfbench import common, counts, readings, traffic
from perfbench.arch import arch, program_config, program_mismatches
from perfbench.families import family
from perfbench.families.moe import capacity
from perfbench.metrics import reader

BENCH = common.benchmark()
CONFIGS = [c["name"] for c in BENCH["configs"]]


@pytest.mark.parametrize("mix", ["chat", "backlog"])
def test_seeded_traffic_repeats_and_each_seed_gets_the_same_work(mix):
    spec = traffic.resolve(common.traffic_file(mix))
    gen = ((lambda s: traffic.open_loop(spec, s, 30.0, 32768)) if spec["kind"] == "open_loop"
           else (lambda s: traffic.backlog(spec, s, 32768)))
    a1, a2, b = gen(2**40 + 7), gen(2**40 + 7), gen(11)
    assert [(r.due_s, r.prompt, r.max_new_tokens) for r in a1] == \
        [(r.due_s, r.prompt, r.max_new_tokens) for r in a2]
    assert Counter(len(r.prompt) for r in a1) == Counter(len(r.prompt) for r in b)
    assert Counter(r.max_new_tokens for r in a1) == Counter(r.max_new_tokens for r in b)
    # a mix with an order_seed replays one schedule; the seed draws the ids
    same_order = "order_seed" in spec
    assert ([len(r.prompt) for r in a1] == [len(r.prompt) for r in b]) == same_order
    assert a1[0].prompt != b[0].prompt
    lo, hi = spec["prompt"]["min"], spec["prompt"]["max"]
    assert all(lo <= len(r.prompt) <= hi for r in a1)
    if spec["kind"] == "open_loop":
        assert len(a1) == round(spec["rate_per_s"] * 30.0)
        def gaps(reqs):
            t = [0.0] + [r.due_s for r in reqs] + [30.0]
            return sorted(y - x for x, y in zip(t, t[1:]))

        dues = [r.due_s for r in a1]
        assert dues == sorted(dues) and 0 < dues[0] and dues[-1] < 30.0
        assert gaps(a1) == pytest.approx(gaps(b))


def test_train_batches_repeat_and_labels_are_the_next_tokens():
    spec = traffic.resolve(common.traffic_file("train-4k"))
    t1, l1 = traffic.train_batch(spec, 5, 3, 151936)
    t2, l2 = traffic.train_batch(spec, 5, 3, 151936)
    t3, _ = traffic.train_batch(spec, 5, 4, 151936)
    assert (t1 == t2).all() and (l1 == l2).all() and not (t1 == t3).all()
    assert t1.shape == (2, 4096) and (t1[:, 1:] == l1[:, :-1]).all()


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("name", CONFIGS)
def test_config_file_matches_the_program(name, smoke):
    from repro_torch.configs import get_config
    a = arch(common.config_file(name), smoke)
    prog = get_config(name, smoke=smoke)
    assert program_mismatches(a, prog) == []
    assert program_mismatches(a, prog.scaled(d_model=a.d + 8))
    # what is not a width the harness sets as the file states it
    run = program_config(a, prog)
    assert (run.n_layers, run.norm_eps, run.window) == (a.n_layers, a.eps, a.window)
    assert run.moe.aux_loss_weight == a.aux_weight
    assert program_mismatches(a, run) == []


def test_traffic_refuses_what_the_generator_does_not_implement():
    chat = common.traffic_file("chat")
    for bad in ({"prefix_sharing": 0.3}, {"arrivals": "bursty"}, {"admission": "fifo"},
                {"prompt": {**chat["prompt"], "dist": "zipf"}},
                {"output": {**chat["output"], "p99": 900}}):
        with pytest.raises(ValueError):
            traffic.resolve({**chat, **bad})
    with pytest.raises(ValueError):
        traffic.resolve({"kind": "closed_loop"})


def test_every_configuration_names_a_family_with_all_its_parts():
    for name in CONFIGS:
        a = arch(common.config_file(name))
        fam = family(a.family)
        for part in ("arch", "mismatches", "program_config", "leaves", "matmul_params", "block"):
            assert callable(getattr(fam, part)), (a.family, part)


def test_benchmark_file_names_existing_files():
    for c in BENCH["configs"]:
        assert (common.ROOT / c["file"]).is_file()
    for w in BENCH["workloads"]:
        common.config_file(w["config"])
        traffic.resolve(common.traffic_file(w["traffic"]))
        assert common.checks_file(w["name"])["limits"]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(reader(m["name"]))


def test_flop_counts_by_hand():
    a = arch(common.config_file("qwen3-moe-30b-a3b"))
    # per layer: q 2048x4096, k and v 2048x512, o 4096x2048; router
    # 2048x128; 8 experts x 3 x 2048x768; 4 layers; head 2048x151936
    per_layer = (8_388_608 + 2 * 1_048_576 + 8_388_608) + 262_144 + 37_748_736
    assert counts.matmul_params(a) == 4 * per_layer + 311_164_928 == 538_705_920
    attn = 4 * 4 * 32 * 128 * (4096 * 4097 // 2)            # a sequence, every layer
    step = 3 * 2 * (2 * 538_705_920 * 4096 + attn)
    assert counts.train_step_flops(a, 2, 4096) == pytest.approx(step, rel=1e-12)
    assert counts.train_step_flops(a, 2, 4096) == pytest.approx(29.78e12, rel=1e-3)
    m = arch(common.config_file("mixtral-8x22b"))
    assert counts.attended_keys(6000, 4096) == 4096 * 4097 // 2 + (6000 - 4096) * 4096
    assert counts.attention_flops(m, 10) == 4 * 12 * 48 * 128 * 10
    # the train shapes' gmm is bytes-bound: 633 MB at 3.35 TB/s
    assert counts.gmm_least_s(128, 320, 2048, 768) == pytest.approx(
        2 * (128 * 320 * 2048 + 128 * 2048 * 768 + 128 * 320 * 768) / 3.35e12)


def test_capacity_rule():
    q = arch(common.config_file("qwen3-moe-30b-a3b"))
    m = arch(common.config_file("mixtral-8x22b"))
    assert capacity(4096, q) == 320 and capacity(256, q) == 256 and capacity(257, q) == 20
    assert capacity(48, m) == 48 and capacity(1000, m) == round(1000 * 2 / 8 * 1.25)
    assert capacity(264, m) == 82          # 82.5 rounds half to even


def _serve_run():
    reqs = [  # due, first token, tokens
        {"due": 0.0, "left_queue": 0.1, "tokens": [0.5, 0.6, 0.7]},
        {"due": 1.0, "left_queue": 1.2, "tokens": [1.4, 1.9, 10.5]},
        {"due": 2.0, "left_queue": None, "tokens": []},
        {"due": 11.0, "left_queue": 11.0, "tokens": [11.2]},
    ]
    rounds = [{"start": 0.0, "end": 0.5, "active": 1, "prefill": True},
              {"start": 0.5, "end": 0.6, "active": 2, "prefill": False},
              {"start": 0.6, "end": 12.0, "active": 2, "prefill": False}]
    return {"kind": "open_loop", "seconds": 10.0, "requests": reqs, "rounds": rounds}


def test_tails_count_every_request_due_and_every_gap_in_the_window():
    run = _serve_run()
    # request 2 never got a token: it waited until the loop stopped (12 s)
    assert sorted(readings.ttfts(run)) == pytest.approx([0.4, 0.5, 10.0])
    # gaps closed by the window's end (10 s); request 3 was not due in it
    assert sorted(readings.token_gaps(run)) == pytest.approx([0.1, 0.1, 0.5])
    assert reader("ttft_p95_ms")(run) == pytest.approx(10_000.0)
    assert reader("itl_p95_ms")(run) == pytest.approx(500.0)
    assert reader("queue_wait_p95_ms.online")(run) == pytest.approx(10_000.0)
    assert reader("round_ms_p50.online")(run) == pytest.approx(100.0)
    assert reader("gen_tokens_per_s")(run) is None


def test_rates_are_over_the_whole_window():
    steps = [{"start": 0.0, "end": 0.5, "tokens": 100}, {"start": 0.5, "end": 2.0, "tokens": 100}]
    assert reader("train_tokens_per_s")({"kind": "train", "steps": steps}) == pytest.approx(100.0)
    rounds = [{"active": 4}, {"active": 2}]
    run = {"kind": "backlog", "rounds": rounds, "window_end": 3.0}
    assert reader("gen_tokens_per_s")(run) == pytest.approx(2.0)
    assert reader("occupancy.offline")(run) == pytest.approx(3.0)


def test_percentile_is_nearest_rank_over_all_values():
    assert common.percentile(list(range(1, 101)), 95) == 95
    assert common.percentile([3.0], 95) == 3.0
    assert common.percentile([], 95) is None


def test_roofline_readers_find_nothing_without_a_trace():
    assert reader("gmm_roofline.train")({"kind": "train"}) is None
    assert reader("idle_share.train")({"kind": "train", "trace": {"recorded": False}}) is None
    run = {"kind": "train", "trace": {"recorded": True, "busy_s": 3.0, "window_s": 4.0}}
    assert reader("idle_share.train")(run) == pytest.approx(25.0)


def test_forbidden_modules_compare_whole_top_level_names():
    assert common.loaded_forbidden(["repro_torch", "repro_torch.models", "jaxtyping",
                                    "reprox", "numpy"]) == []
    assert common.loaded_forbidden(["repro", "repro.models.moe", "jax.numpy", "jaxlib",
                                    "flax.linen"]) == ["flax.linen", "jax.numpy", "jaxlib",
                                                       "repro", "repro.models.moe"]


def test_the_harness_and_the_program_import_nothing_forbidden():
    code = ("import sys; sys.path[:0] = ['src', '.']\n"
            "import perfbench.run, perfbench.check, perfbench.drive_train, perfbench.drive_serve\n"
            "import perfbench.reference.train, perfbench.reference.serve\n"
            "import repro_torch.runtime.serve, repro_torch.runtime.train\n"
            "from perfbench.common import loaded_forbidden\n"
            "print(loaded_forbidden(list(sys.modules)))")
    out = subprocess.run([sys.executable, "-c", code], cwd=common.ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_no_card_no_result():
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                          "serve.mixtral-8x22b.chat", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=common.ROOT, capture_output=True, text=True,
                         timeout=120, env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert not out.stdout.strip()


def test_benchmark_json_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    names = [m["name"] for m in BENCH["end_to_end"]]
    assert "setup_s" in names
    for m in BENCH["per_layer"]:
        assert m["moves"] in names
        e2e = next(x for x in BENCH["end_to_end"] if x["name"] == m["moves"])
        assert set(m["workloads"]) <= set(e2e.get("workloads", m["workloads"]))
    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    unit = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
    for x in BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"] + BENCH["per_layer"]:
        assert name.match(x["name"])
        for k in ("why", "layer", "source"):
            assert 1 <= len(x.get(k, "x")) <= 200 and "\n" not in x.get(k, "")
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert unit.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    for c in BENCH["configs"]:
        assert len(c["reduced"]) <= 16 and all(name.match(k) for k in c["reduced"])
    assert (common.ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_trace_reduction_merges_intervals_and_names_gaps_by_the_host_span():
    from perfbench.trace import reduce
    ms = 1_000_000
    dev = [(0, 2 * ms, "a"), (1 * ms, 3 * ms, "b"), (5 * ms, 6 * ms, "a"), (9 * ms, 12 * ms, "c")]
    spans = [(0, 10 * ms, "round"), (4 * ms, 5 * ms, "decode"), (6 * ms, 7 * ms, "decode")]
    out = reduce(dev, spans, 0, 10 * ms)
    assert out["recorded"] and out["window_s"] == pytest.approx(0.010)
    assert out["busy_s"] == pytest.approx(0.005)              # [0,3) [5,6) [9,10)
    assert out["device_ops"][0] == ["a", pytest.approx(0.003)]
    gaps = dict(out["idle_gaps"])                              # [3,5) mid 4; [6,9) mid 7.5
    assert gaps == {"decode": pytest.approx(0.002), "round": pytest.approx(0.003)}
    assert reduce([], spans, 0, ms) == {"window_s": pytest.approx(0.001), "recorded": False}
