"""The operation and byte arithmetic against hand counts, the frozen plan
against the published network, and the peaks."""
import json

import pytest

from portbench import counts, manifest, peaks

CFG = manifest.config("vgg16")
ART = json.loads((manifest.PKG / "configs" / CFG["artifact"]).read_text())


def test_the_frozen_plan_is_vgg16_d():
    """13 SAME 3x3 convs at the published widths, a 2x2 max pool after
    convs 2, 4, 7, 10 and 13, then 25088 -> 4096 -> 4096 -> 1000."""
    nodes = counts.plan_nodes(ART)
    convs = [n["op"] for n in nodes if n["kind"] == "conv"]
    assert [[c["H_in"], c["C_in"], c["C_out"]] for c in convs] == \
        CFG["convs"]
    assert all(c["K"] == 3 and c["S"] == 1 and c["H_in"] == c["W_in"]
               for c in convs)
    linears = [n["op"] for n in nodes if n["kind"] == "linear"]
    assert [[x["C_in"], x["C_out"]] for x in linears] == \
        CFG["fully_connected"]
    assert all(x["L"] == 1 for x in linears)
    seen, pools_after = 0, []
    for n in nodes:
        seen += n["kind"] == "conv"
        if n["kind"] == "pool":
            pools_after.append(seen)
    assert pools_after == CFG["pools_after_convs"]
    weights = sum(9 * c["C_in"] * c["C_out"] for c in convs) + \
        sum(x["C_in"] * x["C_out"] for x in linears)
    assert weights == CFG["weights"]
    # the published count less one bias per output channel and unit
    biases = sum(c["C_out"] for c in convs) + sum(x["C_out"]
                                                  for x in linears)
    assert weights + biases == CFG["published_weights"]


def test_vgg16_work_per_request():
    work = counts.plan_request(ART)
    assert len(work["conv"]) == 13 and len(work["linear"]) == 3
    assert len(work["pool"]) == 5
    # 15.35 G multiply-adds in the convs, 123.6 M in the linear layers
    conv_macs = sum(h * h * 9 * ci * co for h, ci, co in CFG["convs"])
    assert conv_macs == 15_346_630_656
    assert sum(w.flops for w in work["conv"]) == 2 * conv_macs
    assert sum(w.flops for w in work["linear"]) == 2 * 123_633_664
    # each product moves x, W and y once, fp32
    assert sum(w.bytes for w in work["linear"]) == 4 * (
        123_633_664 + 25088 + 4096 + 4096 + 4096 + 4096 + 1000)
    # the first conv: the image, the filter and the output once
    assert work["conv"][0].bytes == 4 * (224 * 224 * 3 + 27 * 64
                                         + 224 * 224 * 64)
    # a 2x2 pool reads every element once and writes a quarter
    assert work["pool"][0].bytes == 4 * 224 * 224 * 64 * 5 / 4


def test_winograd_products():
    work = counts.plan_request(ART)["hadamard"]
    # the 3x3 convs with >= 128 outputs, >= 32 inputs and >= 1024 pixels:
    # 112^2 64->128, 128->128; 56^2 128->256, 256->256 twice
    assert len(work) == 5
    macs = 16 * (56 * 56 * (64 * 128 + 128 * 128)
                 + 28 * 28 * (128 * 256 + 2 * 256 * 256))
    assert sum(w.flops for w in work) == 2 * macs
    one = counts.hadamard_product({"H_in": 3, "W_in": 5, "C_in": 2,
                                   "C_out": 7, "K": 3, "S": 1}, 4)
    assert one.flops == 16 * 2 * (2 * 3) * 2 * 7
    assert one.bytes == 16 * 4 * (6 * 2 + 2 * 7 + 6 * 7)


def test_pool_edge_from_bytes():
    assert counts.pool_edge(4 * 112 * 112 * 64, 64) == 112
    assert counts.pool_edge(4 * 2048, 2048) == 1


def test_roofline_takes_the_larger_bound():
    w = counts.Work(flops=1e12, bytes=1e9)
    assert w.seconds(1e12, 1e12) == 1.0
    assert counts.Work(1.0, 4e12).seconds(1e12, 1e12) == 4.0


def test_peaks_by_precision():
    name = "NVIDIA H100 80GB HBM3"
    assert peaks.compute_peak(name, "float32") == 495e12
    assert peaks.compute_peak(name, "bfloat16") == 989e12
    assert peaks.memory_peak(name) == 3.35e12
