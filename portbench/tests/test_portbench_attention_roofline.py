"""`attention_roofline.prefill`: the prefill attention kernel's share of the
least time its work takes, read from a hand-made trace and checked by
hand; nothing where the kernel never ran; and a traced CPU run of the
`zamba2-7b.prefill` cell at a test's size, which leaves it out."""
import pytest

from portbench import manifest, run
from portbench.trace import Trace

DOC = manifest.load()
CELL = manifest.cell(DOC, "zamba2-7b.prefill")
PUBLISHED = manifest.config("zamba2-7b")
NAME = "attention_roofline.prefill"
KERNEL = ("void repro_torch::(anonymous namespace)::prefill_attention_fwd"
          "<224>(repro_torch::(anonymous namespace)::Args)")
OTHER = "void repro_torch::(anonymous namespace)::ssd_chunk_state<64>(int)"


class _Driver:
    """The prefill driver's lengths: call i prefills 1024, 2048, 4096
    tokens in turn."""
    precision = "bfloat16"

    def length(self, i):
        return (1024, 2048, 4096)[i % 3]


def _run(trace=None, first=0):
    return run.Run(CELL, PUBLISHED, {"batch": 4}, _Driver(),
                   "NVIDIA H100 80GB HBM3", [], 0.0, 1.0, trace=trace,
                   traced_first=first)


def _trace(device, calls=3):
    return Trace(device=device, host=[], launches=len(device), calls=calls,
                 window=(0.0, 1e7))


def test_the_metric_is_declared_for_the_prefill_cell_only():
    m = [x for x in DOC["per_layer"] if x["name"] == NAME]
    assert m == [{"name": NAME, "unit": "%", "better": "higher",
                  "source": "device_trace", "layer": "Kernels",
                  "moves": "plan_requests_per_s",
                  "workloads": ["zamba2-7b.prefill"]}]
    assert DOC["per_layer"][-1]["name"] == NAME


@pytest.mark.parametrize("trace", [
    None,
    _trace([(0.0, 10.0, OTHER)]),                     # another kernel only
    _trace([(0.0, 10.0, KERNEL)], calls=0),           # no call traced
], ids=["no trace", "no attention kernel", "no call"])
def test_it_reads_nothing_where_the_kernel_never_ran(trace):
    assert manifest.reader(NAME).read(_run(trace)) is None


def test_a_hand_made_trace_read_by_hand():
    """Three traced calls (4 x 1024, 2048, 4096 tokens) in which the
    kernel ran 13 times each for 20, 60 and 230 ms in all, two launches
    of the last call overlapping by 1 ms (counted once), beside an SSD
    kernel that does not count."""
    # 13 hybrid layers, 32 heads of 224, batch 4: operations and bytes
    # of each call's attention, by hand
    bound = 0.0
    for t in (1024, 2048, 4096):
        ops = 13 * 4 * 2 * 32 * 224 * t * (t + 1)
        moved = 13 * 2 * 4 * t * 224 * (32 + 32 + 32 + 32)
        bound += max(ops / 989e12, moved / 3.35e12)
    # at 1024 tokens the bytes (3.05 GB: 0.91 ms) outlast the operations
    # (0.78 TFLOP: 0.79 ms); at 2048 and 4096 the operations bound
    assert 13 * 4 * 2 * 32 * 224 * 1024 * 1025 / 989e12 < \
        13 * 2 * 4 * 1024 * 224 * 128 / 3.35e12
    assert 13 * 4 * 2 * 32 * 224 * 2048 * 2049 / 989e12 > \
        13 * 2 * 4 * 2048 * 224 * 128 / 3.35e12
    us = 1e3                                          # trace clock: us
    device = [(0.0, 20 * us, KERNEL),
              (100 * us, 160 * us, KERNEL),
              (200 * us, 316 * us, KERNEL),
              (315 * us, 431 * us, KERNEL),           # 1 ms overlap
              (500 * us, 900 * us, OTHER)]
    got = manifest.reader(NAME).read(_run(_trace(device)))
    kernel_s = (20 + 60 + 231) / 1e3
    assert got == pytest.approx(100 * bound / kernel_s, rel=1e-12)
    # 12.51 TFLOP at 4096 tokens and 3.13 at 2048 at the bf16 peak, 3.05
    # GB at 1024 at the HBM rate: 16.73 ms over 311 ms of kernel time
    want = (12.5100e12 + 3.1283e12) / 989e12 + 3.0535e9 / 3.35e12
    assert got == pytest.approx(100 * want / 0.311, rel=1e-4)


def test_the_traced_calls_start_where_the_window_ended():
    """The lengths are those of the traced calls, not of calls 0..2:
    a slice that starts at call 4 takes 2048, 4096, 1024."""
    device = [(0.0, 1e5, KERNEL)]
    reader = manifest.reader(NAME)
    at0 = reader.read(_run(_trace(device), first=0))
    at4 = reader.read(_run(_trace(device), first=4))
    assert at0 == pytest.approx(at4, rel=1e-12)       # the same three
    one = _trace(device, calls=1)
    assert reader.read(_run(one, first=2)) > reader.read(_run(one, first=0))


def test_a_traced_cpu_run_leaves_it_out():
    from test_portbench_zamba2 import MIX, tiny_config

    res = run.execute(DOC, CELL, 2**33 + 21, 0.3, True, "cpu",
                      config=tiny_config(), mix=MIX,
                      limits={"logit_err": 1e-4})
    assert res["correct"], res["checks"]
    assert NAME not in res["metrics"]
    assert "ssd_calls.prefill" in res["metrics"]
