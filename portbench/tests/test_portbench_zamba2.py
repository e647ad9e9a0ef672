"""The `zamba2-7b.prefill` cell at a size a test can hold, on the CPU:
the `prefill` driver through the whole run, the weights it draws, its
faults and control (in fp32 against a tight limit, and in bf16 against
the cell's own), the counts against hand counts, and the new readers with
nothing to read."""
import json

import pytest
import torch

from portbench import counts, counts_zamba2, manifest, run, traffic

DOC = manifest.load()
CELL = manifest.cell(DOC, "zamba2-7b.prefill")
PUBLISHED = manifest.config("zamba2-7b")

MIX = {"batch": 2, "pool": 6, "trace_calls": 3, "check_calls": 3}
#: in fp32 the program computes what the reference does to ~3e-6 at this
#: size (the scan in chunks of 64 against the reference's 8); one fp8
#: rounding of each product's operands misses by ~0.4
LIMITS = {"logit_err": 1e-4}
#: the cell's own limits, for the tiny model in bf16 as the cell runs
CELL_LIMITS = manifest.limits(CELL["name"])
KINDS = ["mamba", "hybrid", "mamba", "hybrid", "hybrid", "mamba", "mamba"]
NEW_READERS = ["prefill_mfu", "ssd_chunk_roofline.prefill",
               "idle_share.prefill", "device_ms.prefill",
               "prefill_host_ms.prefill", "shared_host_ms.prefill",
               "ssd_calls.prefill"]


def tiny_config():
    """The published configuration's keys at d = 64: four heads of 32 over
    the 128-wide concat, 2 groups, 2 blocks, rank 8, seven layers of which
    1, 3 and 4 are hybrid; fp32; prompts of 8, 16 and 24 tokens."""
    cfg = dict(PUBLISHED)
    cfg.update(hidden_size=64, num_hidden_layers=7, layers_block_type=KINDS,
               hybrid_layer_ids=[1, 3, 4], num_attention_heads=4,
               num_key_value_heads=4, attention_head_dim=32,
               attention_hidden_size=128, kv_channels=16,
               intermediate_size=128, ffn_hidden_size=128, adapter_rank=8,
               mamba_d_state=16, mamba_headdim=16, n_mamba_heads=8,
               vocab_size=512, chunk_size=8, dtype="float32",
               serving={"prompt_lengths": [8, 16, 24], "max_new_tokens": 1,
                        "max_batch": 4, "max_len": 24})
    return cfg


@pytest.fixture(scope="module")
def config():
    return tiny_config()


@pytest.fixture(scope="module")
def bf16_config():
    return dict(tiny_config(), dtype="bfloat16")


def _run(config, seed=2**33 + 17, traced=False, limits=LIMITS):
    return run.execute(DOC, CELL, seed, 0.3, traced, "cpu", config=config,
                       mix=MIX, limits=limits)


def test_sound_run(config):
    res = _run(config)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert set(res["metrics"]) == {"plan_requests_per_s", "plan_ms_p95",
                                   "setup_s"}


def test_traced_run_reads_the_program_counters_and_spans(config):
    res = _run(config, traced=True)
    assert res["correct"], res["checks"]
    got = res["metrics"]
    assert got["ssd_calls.prefill"]["value"] == 7 * 2
    for name in ("prefill_mfu", "prefill_host_ms.prefill",
                 "shared_host_ms.prefill"):
        assert got[name]["value"] > 0, name
    # no card, so no device operation and no SSD kernel
    assert "ssd_chunk_roofline.prefill" not in got
    assert "device_ms.prefill" not in got


def test_same_seed_same_inputs(config):
    drv = [manifest.driver("prefill").Driver(config, traffic.mix(MIX), "cpu")
           for _ in range(2)]
    for d in drv:
        d.prepare(2**40 + 5)
    assert all((a == b).all() for a, b in zip(drv[0].pool, drv[1].pool))
    assert torch.equal(drv[0].params["layers"][3]["w_in"],
                       drv[1].params["layers"][3]["w_in"])
    assert [p.shape[1] for p in drv[0].pool] == [8, 16, 24] * 2


def test_control_fails(config):
    drv = manifest.driver("prefill").Driver(config, traffic.mix(MIX), "cpu")
    drv.prepare(5)
    run.window(drv, 0.3, lambda: None)
    program, control = drv.check(), drv.check(control=True)
    assert program["logit_err"] <= LIMITS["logit_err"]
    assert control["logit_err"] > 100 * LIMITS["logit_err"]


@pytest.mark.parametrize("seed", [1, 2**40 + 5])
def test_bf16_under_the_cell_limit_and_its_control_over(bf16_config, seed):
    """In bf16, as the cell runs, the tiny model reads 0.03-0.05 against
    the cell's 0.15, and the fp8 control 0.45-0.72."""
    drv = manifest.driver("prefill").Driver(bf16_config, traffic.mix(MIX),
                                            "cpu")
    drv.prepare(seed)
    run.window(drv, 0.3, lambda: None)
    limit = CELL_LIMITS["logit_err"]
    assert drv.check()["logit_err"] <= limit / 2
    assert drv.check(control=True)["logit_err"] > 2 * limit


def test_the_benchmark_draws_the_weights_and_keeps_its_own(config):
    """The published init rules, in the program's layout, and a program
    copy that shares no storage with the benchmark's."""
    from repro_torch.models.zamba2_published import (Zamba2Layout,
                                                     Zamba2PublishedModel)

    drv = manifest.driver("prefill").Driver(config, traffic.mix(MIX), "cpu")
    drv.prepare(2**35 + 3)
    heads = config["n_mamba_heads"]
    lo = max(config["time_step_min"], config["time_step_floor"])
    for p in drv.weights["layers"]:
        assert torch.equal(p["A_log"], torch.log(torch.arange(
            1, heads + 1, dtype=torch.float32)))
        assert torch.equal(p["D"], torch.ones(heads))
        dt = torch.nn.functional.softplus(p["dt_bias"])
        assert (dt >= lo * (1 - 1e-4)).all()
        assert (dt <= config["time_step_max"] * (1 + 1e-4)).all()
    w_in = drv.weights["layers"][0]["w_in"]
    assert abs(float(w_in.std()) * config["hidden_size"] ** 0.5 - 1) < 0.05
    ours = Zamba2PublishedModel(Zamba2Layout.from_hf(config)).init(
        torch.Generator().manual_seed(0))

    def leaves(tree):
        if isinstance(tree, dict):
            return [x for k in sorted(tree) for x in leaves(tree[k])]
        if isinstance(tree, list):
            return [x for v in tree for x in leaves(v)]
        return [tree]
    mine, given = leaves(drv.weights), leaves(drv.params)
    assert [(t.shape, t.dtype) for t in mine] == \
        [(t.shape, t.dtype) for t in leaves(ours)]
    assert all(torch.equal(a, b) for a, b in zip(mine, given))
    assert not {t.data_ptr() for t in mine} & {t.data_ptr() for t in given}


# ------------------------------------------------------------------ faults
def _plant(monkeypatch, fault):
    from repro_torch.models.zamba2_published import Zamba2PublishedModel

    if fault == "one group":
        real = Zamba2PublishedModel._scan

        def one_group(self, xs, bmat, cmat, dt, a, state):
            first = [m[:, :, :1].expand_as(m) for m in (bmat, cmat)]
            return real(self, xs, *first, dt, a, state)
        monkeypatch.setattr(Zamba2PublishedModel, "_scan", one_group)
    elif fault == "adapter dropped":
        real = Zamba2PublishedModel._mlp

        def no_adapter(self, blk, hyb, h):
            return real(self, blk, dict(hyb, lora_b=torch.zeros_like(
                hyb["lora_b"])), h)
        monkeypatch.setattr(Zamba2PublishedModel, "_mlp", no_adapter)
    elif fault == "scale 224^-1/2":
        real = Zamba2PublishedModel.__init__

        def full_head(self, cfg):
            real(self, cfg)
            self.scale = cfg.attention_head_dim ** -0.5
        monkeypatch.setattr(Zamba2PublishedModel, "__init__", full_head)
    else:
        # the program rewrites the weights it was handed, in place, before
        # each prefill: by another A_log or dt_bias rule, or with the
        # mixers' weights of its own draw from `init`
        real = Zamba2PublishedModel.prefill
        rule = REWRITES[fault]

        def rewritten(self, params, *args, **kw):
            with torch.no_grad():
                rule(self, params)
            return real(self, params, *args, **kw)
        monkeypatch.setattr(Zamba2PublishedModel, "prefill", rewritten)


def _own_draw(model, params):
    drawn = model.init(torch.Generator(
        device=params["embed"].device).manual_seed(1))
    for p, q in zip(params["layers"], drawn["layers"]):
        for k in p:
            p[k].copy_(q[k])


REWRITES = {
    "A_log rule": lambda m, params: [p["A_log"].zero_()
                                     for p in params["layers"]],
    "dt_bias rule": lambda m, params: [p["dt_bias"].zero_()
                                       for p in params["layers"]],
    "the program's own draw": _own_draw,
}
FAULTS = ["one group", "adapter dropped", "scale 224^-1/2", *REWRITES]


@pytest.mark.parametrize("fault", FAULTS)
def test_faults_are_not_correct(config, monkeypatch, fault):
    _plant(monkeypatch, fault)
    res = _run(config)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("fault", FAULTS)
def test_faults_are_over_the_cell_limit_in_bf16(bf16_config, monkeypatch,
                                                fault):
    """Each fault, in bf16 as the cell runs, against the cell's own
    limit: 0.24-1.9 at this size over four seeds, where the program
    reads 0.03-0.05."""
    _plant(monkeypatch, fault)
    res = _run(bf16_config, limits=CELL_LIMITS)
    assert not res["correct"], res["checks"]


# ------------------------------------------------------------------ counts
def test_the_published_counts():
    """7,356,749,648 weights: 81 mixers of 78,437,456, 2 blocks of
    333,982,208, 13 hybrid layers of 12,845,056 + 4,128,768, the
    embedding and the final norm; 21.82 GFLOP of projections a token."""
    cfg = PUBLISHED
    mixer = 3584 * 14704 + 5 * 7424 + 3 * 112 + 7168 + 7168 * 3584 + 3584
    block = (7168 + 7168 * 21504 + 7168 * 3584 + 3584 + 3584 * 28672
             + 14336 * 3584)
    hybrid = 3584 ** 2 + 3584 * 128 + 128 * 28672
    assert (mixer, block, hybrid) == (78_437_456, 333_982_208,
                                      12_845_056 + 4_128_768)
    assert counts_zamba2.weight_params(cfg) == \
        32000 * 3584 + 3584 + 81 * mixer + 2 * block + 13 * hybrid == \
        cfg["weights"] == 7_356_749_648
    per_token = 81 * (3584 * 14704 + 7168 * 3584) + 13 * (
        7168 * 21504 + 7168 * 3584 + 3584 * 28672 + 14336 * 3584
        + 3584 * 128 + 128 * 28672 + 3584 ** 2)
    assert counts_zamba2.projection_params(cfg) == per_token
    assert 2 * per_token == 21_823_635_456


@pytest.mark.parametrize("t", [1024, 4096])
def test_a_prefill_call_by_hand(t):
    b = 4
    w = counts_zamba2.prefill_call(PUBLISHED, b, t)
    want = (2 * 21_823_635_456 / 2 * b * t
            + 13 * b * 2 * 32 * 224 * t * (t + 1)
            + 81 * b * t * 4 * 112 * 64 * 64
            + 81 * b * t * 2 * 4 * 7424
            + b * 2 * 3584 * 32000)
    assert w.flops == want
    assert w.bytes == 2 * 7_356_749_648


def test_an_ssd_call_by_hand():
    b, t = 4, 2048
    w = counts_zamba2.ssd_call(PUBLISHED, b, t)
    assert w.flops == 4 * 64 * 64 * 56 * b * t
    # x and y (B, T, 56, 64) and B and C (B, T, 64) at 2 bytes; dt
    # (B, T, 56), a (56,) and two states (B, 56, 64, 64) at 4
    assert w.bytes == (2 * (2 * b * t * 56 * 64 + 2 * b * t * 64)
                       + 4 * (b * t * 56 + 56 + 2 * b * 56 * 64 * 64))
    assert len(counts_zamba2.ssd_calls(PUBLISHED, b, t)) == 162
    # bytes bound at the bf16 peak: it reads over 100 % only if it lies
    assert w.seconds(989e12, 3.35e12) == w.bytes / 3.35e12


# ------------------------------------------------------ readers, nothing
class _Driver:
    precision = "bfloat16"

    def work(self, i):
        return {"model": [counts.Work(1.0, 1.0)], "ssd": []}


def _empty_run(trace=None, calls=()):
    return run.Run(CELL, PUBLISHED, MIX, _Driver(), "NVIDIA H100 80GB HBM3",
                   list(calls), 0.0, 1.0, trace=trace)


@pytest.mark.parametrize("name", NEW_READERS)
def test_new_readers_read_nothing_without_spans_or_a_trace(name):
    from portbench.trace import Trace

    reader = manifest.reader(name)
    assert reader.read(_empty_run()) is None
    # a trace of no call: one device op, no program span, an empty window
    bare = Trace(device=[(0.0, 10.0, "void some_kernel<float>(int)")],
                 host=[], launches=1, calls=0, window=(0.0, 0.0))
    assert reader.read(_empty_run(bare)) is None


def test_the_config_file_holds_the_catalog_entry():
    """Every number of the catalog's config, under its own key, and the
    layer types it lists."""
    ids = [i for i, k in enumerate(PUBLISHED["layers_block_type"])
           if k == "hybrid"]
    assert ids == PUBLISHED["hybrid_layer_ids"]
    assert PUBLISHED["reduced"] == [] and PUBLISHED["departures"] == []
    assert json.loads(json.dumps(PUBLISHED["serving"])) == {
        "prompt_lengths": [1024, 2048, 4096], "max_new_tokens": 1,
        "max_batch": 4, "max_len": 4096}


def test_the_reference_loads_nothing_of_the_program():
    from test_portbench_imports import _loaded
    from portbench.run import forbidden_modules

    mods = _loaded("import portbench.reference.zamba2, "
                   "portbench.counts_zamba2")
    assert forbidden_modules(mods) == []
    assert not any(m.split(".")[0] in ("repro_torch", "transformers")
                   for m in mods)
