"""The card's published peaks, frozen here so that no change to the
program moves the yardstick.

Copied from `src/repro_torch/roofline/analysis.py` (`PEAKS`), as it stood
at commit b5c5839: NVIDIA's H100 data sheet, dense rates without
sparsity, at the full power limit (SXM 700 W, PCIe 350 W).  The card's
`power.limit` is read at run time and printed beside the shares.

A share of a roofline or of a peak takes the compute peak of the cell's
precision: fp32 cells the TF32 tensor-core peak, the fastest rate at which
any product can take fp32 inputs (3xTF32 reaches a third of it, bf16x3
two thirds), so no correct fp32 kernel reads over 100 %; bf16 cells the
bf16 peak.  Memory is the HBM rate for both.
"""
from __future__ import annotations

from typing import Dict

PEAKS = {
    "sxm": {"bytes": 3.35e12, "float32": 67e12, "bfloat16": 989e12,
            "tf32": 495e12, "nvlink": 450e9},
    "pcie": {"bytes": 2.0e12, "float32": 51e12, "bfloat16": 756e12,
             "tf32": 378e12, "nvlink": 300e9},
}

#: the compute peak that bounds a cell of each precision
COMPUTE_KEY = {"float32": "tf32", "bfloat16": "bfloat16"}


def peaks_for(device_name: str) -> Dict[str, float]:
    """The peaks of the part `device_name` names: PCIe if it says so, else
    SXM."""
    return PEAKS["pcie"] if "PCIe" in device_name else PEAKS["sxm"]


def compute_peak(device_name: str, precision: str) -> float:
    """FLOP/s that bound a cell computed in `precision`."""
    return peaks_for(device_name)[COMPUTE_KEY[precision]]


def memory_peak(device_name: str) -> float:
    return peaks_for(device_name)["bytes"]
