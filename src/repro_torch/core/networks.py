"""Operation graphs of the paper's end-to-end networks (Section 5.4).

Each network is a flat list of scheduling units: ("conv", ConvOp),
("linear", LinearOp) or ("pool", out_bytes).  Pooling is always scheduled on
the GPU (paper: negligible latency, avoids a synchronization point).
Input resolution is 224x224x3, as in the paper's ImageNet models.

The port's copy of `repro.core.networks`: the unit lists lower into the
graph IR via `graph.ir.from_units`, and a plan over one of them carries the
same network fingerprint in both packages.
"""
from __future__ import annotations

import math
from typing import List, Tuple, Union

from repro_torch.core.types import ConvOp, LinearOp

Unit = Tuple[str, Union[ConvOp, LinearOp, int]]


def pool_out_edge(pool_bytes: int, c: int) -> int:
    """Output edge length of a square pool unit from its recorded float32
    byte count: bytes = 4 * edge^2 * c (edge 1 = global pooling)."""
    if pool_bytes <= 0:
        raise ValueError(f"pool unit needs a positive output byte count, "
                         f"got {pool_bytes}")
    if c <= 0:
        raise ValueError(f"pool unit needs a positive channel count, got {c}")
    return max(1, math.isqrt(max(1, pool_bytes // (4 * c))))


def vgg16() -> List[Unit]:
    cfg = [(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)]
    units: List[Unit] = []
    h, c_in = 224, 3
    for c_out, reps in cfg:
        for _ in range(reps):
            units.append(("conv", ConvOp(h, h, c_in, c_out, 3, 1)))
            c_in = c_out
        units.append(("pool", 4 * (h // 2) * (h // 2) * c_out))
        h //= 2
    units.append(("linear", LinearOp(1, 7 * 7 * 512, 4096)))
    units.append(("linear", LinearOp(1, 4096, 4096)))
    units.append(("linear", LinearOp(1, 4096, 1000)))
    return units


def _resnet(blocks: List[int]) -> List[Unit]:
    units: List[Unit] = [("conv", ConvOp(224, 224, 3, 64, 7, 2)),
                         ("pool", 4 * 56 * 56 * 64)]
    h, c_in = 56, 64                       # resolution/channels entering stage
    for stage, n in enumerate(blocks):
        c_out = 64 * 2 ** stage
        for b in range(n):
            stride = 2 if (stage > 0 and b == 0) else 1
            units.append(("conv", ConvOp(h, h, c_in, c_out, 3, stride)))
            h_out = h // stride
            units.append(("conv", ConvOp(h_out, h_out, c_out, c_out, 3, 1)))
            if stride == 2 or c_in != c_out:   # projection shortcut
                units.append(("conv", ConvOp(h, h, c_in, c_out, 1, stride)))
            h, c_in = h_out, c_out
    units.append(("pool", 4 * c_in))
    units.append(("linear", LinearOp(1, c_in, 1000)))
    return units


def resnet18() -> List[Unit]:
    return _resnet([2, 2, 2, 2])


def resnet34() -> List[Unit]:
    return _resnet([3, 4, 6, 3])


def inception_v3() -> List[Unit]:
    """Inception-v3 conv graph (channel spec follows Szegedy et al. 2016 /
    torchvision; 'A/B/C/D/E' mixed modules; 299x299 input)."""
    u: List[Unit] = []
    # stem
    u += [("conv", ConvOp(299, 299, 3, 32, 3, 2)),
          ("conv", ConvOp(149, 149, 32, 32, 3, 1)),
          ("conv", ConvOp(147, 147, 32, 64, 3, 1)),
          ("pool", 4 * 73 * 73 * 64),
          ("conv", ConvOp(73, 73, 64, 80, 1, 1)),
          ("conv", ConvOp(73, 73, 80, 192, 3, 1)),
          ("pool", 4 * 35 * 35 * 192)]

    def convs(h, seq):
        res = []
        for c_in, c_out, k, s in seq:
            res.append(("conv", ConvOp(h, h, c_in, c_out, k, s)))
        return res

    # 3x Mixed A @35x35 (in 192/256/288)
    for c_in, pool_c in ((192, 32), (256, 64), (288, 64)):
        u += convs(35, [(c_in, 64, 1, 1),                       # b1
                        (c_in, 48, 1, 1), (48, 64, 5, 1),       # b2
                        (c_in, 64, 1, 1), (64, 96, 3, 1), (96, 96, 3, 1),
                        (c_in, pool_c, 1, 1)])                  # pool proj
        u.append(("pool", 4 * 35 * 35 * c_in))
    # Mixed B (grid reduction) @35->17
    u += convs(35, [(288, 384, 3, 2), (288, 64, 1, 1)])
    u += [("conv", ConvOp(35, 35, 64, 96, 3, 1)),
          ("conv", ConvOp(35, 35, 96, 96, 3, 2)),
          ("pool", 4 * 17 * 17 * 288)]
    # 4x Mixed C @17x17 (768 channels).  The 7x1/1x7 factorized convs are
    # modeled as K=7 ConvOps with C_in/7: this preserves both the FLOPs
    # (2*H*W*7*C_in*C_out) and the weight bytes (7*C_in*C_out*4) of the true
    # asymmetric kernel while staying in the square-filter op grammar.
    def f7(c):                                     # factorized-conv C_in
        return max(1, c // 7)
    for c7 in (128, 160, 160, 192):
        u += convs(17, [(768, 192, 1, 1),                       # b1
                        (768, c7, 1, 1), (f7(c7), c7, 7, 1),
                        (f7(c7), 192, 7, 1),
                        (768, c7, 1, 1), (f7(c7), c7, 7, 1),
                        (f7(c7), c7, 7, 1), (f7(c7), c7, 7, 1),
                        (f7(c7), 192, 7, 1),
                        (768, 192, 1, 1)])                      # pool proj
        u.append(("pool", 4 * 17 * 17 * 768))
    # Mixed D (reduction) @17->8
    u += convs(17, [(768, 192, 1, 1)])
    u += [("conv", ConvOp(17, 17, 192, 320, 3, 2))]
    u += convs(17, [(768, 192, 1, 1), (f7(192), 192, 7, 1),
                    (f7(192), 192, 7, 1)])
    u += [("conv", ConvOp(17, 17, 192, 192, 3, 2)),
          ("pool", 4 * 8 * 8 * 768)]
    # 2x Mixed E @8x8 (1280/2048 in)
    for c_in in (1280, 2048):
        u += convs(8, [(c_in, 320, 1, 1),
                       (c_in, 384, 1, 1), (384, 384, 3, 1), (384, 384, 3, 1),
                       (c_in, 448, 1, 1), (448, 384, 3, 1), (384, 384, 3, 1),
                       (384, 384, 3, 1),
                       (c_in, 192, 1, 1)])
        u.append(("pool", 4 * 8 * 8 * c_in))
    u.append(("pool", 4 * 2048))
    u.append(("linear", LinearOp(1, 2048, 1000)))
    return u


NETWORKS = {
    "vgg16": vgg16,
    "resnet18": resnet18,
    "resnet34": resnet34,
    "inception_v3": inception_v3,
}
