"""Roofline terms of one step: the port's counterpart of
`repro.roofline.analysis`.

Three terms per (arch x shape x mesh), in seconds, against one NVIDIA
H100 SXM's published dense peaks (NVIDIA's H100 data sheet, SXM part at
its 700 W power limit):

    compute    = FLOPs / (chips * 989e12)        bf16 tensor-core peak
    memory     = bytes / (chips * 3.35e12)       HBM3
    collective = collective_bytes / (chips * 450e9)   NVLink, each way

The counts come from `roofline.op_walk`, which walks the step's eager op
stream on fake tensors, and are those of the global program: the
reference multiplies one device's compiled program by the device count,
which also counts work its partitioner replicates.  On a mesh of more
than one device nothing in the port says what a partitioner would move,
so `collective_bytes` is None there and the bottleneck is chosen from
the terms that were counted.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

#: published dense peaks (NVIDIA data sheets, no sparsity, at the full
#: power limit: SXM 700 W, PCIe 350 W): memory bytes/s and operations/s by
#: input type; fp32 runs outside the tensor cores (TF32 off), TF32 on them
#: (the SSD chunk kernels' 3xTF32 products: three TF32 products per fp32
#: one); nvlink is bytes/s each way
PEAKS = {
    "sxm": {"bytes": 3.35e12, "float32": 67e12, "bfloat16": 989e12,
            "tf32": 495e12, "nvlink": 450e9},
    "pcie": {"bytes": 2.0e12, "float32": 51e12, "bfloat16": 756e12,
             "tf32": 378e12, "nvlink": 300e9},
}

PEAK_FLOPS = PEAKS["sxm"]["bfloat16"]      # bf16 per card
HBM_BW = PEAKS["sxm"]["bytes"]             # bytes/s per card
NVLINK_BW = PEAKS["sxm"]["nvlink"]         # bytes/s per card, each way


def peaks_for(device_name: str) -> dict:
    """The peaks of the part `device_name` (torch.cuda.get_device_name)
    names: PCIe if it says so, else SXM."""
    return PEAKS["pcie"] if "PCIe" in device_name else PEAKS["sxm"]


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float              # global program
    hlo_bytes: float              # global program
    collective_bytes: Optional[float]   # None: not countable on this mesh
    collective_breakdown: Dict[str, int]
    model_flops: float            # 6*N*D (or 6*N_active*D)
    peak_memory_bytes: float      # per device
    peaks: dict = dataclasses.field(default_factory=lambda: PEAKS["sxm"])

    @property
    def t_compute(self) -> float:
        return self.hlo_flops / (self.chips * self.peaks["bfloat16"])

    @property
    def t_memory(self) -> float:
        return self.hlo_bytes / (self.chips * self.peaks["bytes"])

    @property
    def t_collective(self) -> Optional[float]:
        if self.collective_bytes is None:
            return None
        return self.collective_bytes / (self.chips * self.peaks["nvlink"])

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        counted = {k: v for k, v in terms.items() if v is not None}
        return max(counted, key=counted.get)

    @property
    def useful_flops_ratio(self) -> float:
        return self.model_flops / max(self.hlo_flops, 1.0)

    def to_dict(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "hlo_flops": self.hlo_flops, "hlo_bytes": self.hlo_bytes,
            "collective_bytes": self.collective_bytes,
            "collective_breakdown": self.collective_breakdown,
            "model_flops": self.model_flops,
            "peak_memory_bytes": self.peak_memory_bytes,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "useful_flops_ratio": self.useful_flops_ratio,
        }


def model_flops_estimate(cfg, shape) -> float:
    """MODEL_FLOPS: 6*N*D for training; 2*N*D forward-only (prefill);
    2*N*1 token for decode.  MoE uses active params."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch          # one token per sequence


def build_report(arch: str, shape, mesh_name: str, chips: int, cost,
                 peak_memory_bytes: float, cfg,
                 peaks: Optional[dict] = None) -> RooflineReport:
    """The report of one walked step (`cost`: `op_walk.analyze`'s
    `CompCost`).  Collectives are counted on a one-device mesh only (a
    one-device program issues none)."""
    coll = {k: int(v) for k, v in cost.coll.items()}
    return RooflineReport(
        arch=arch, shape=shape.name, mesh=mesh_name, chips=chips,
        hlo_flops=float(cost.flops), hlo_bytes=float(cost.bytes_),
        collective_bytes=(float(sum(coll.values())) if chips == 1
                          else None),
        collective_breakdown=coll,
        model_flops=model_flops_estimate(cfg, shape),
        peak_memory_bytes=float(peak_memory_bytes),
        peaks=peaks or PEAKS["sxm"])
