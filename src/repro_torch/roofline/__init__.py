"""Roofline terms of a step from its counted op stream: the port's
counterpart of `repro.roofline` (`analysis`, and `op_walk` in place of
`hlo_walk`), with the H100's peaks and `NVLINK_BW` in place of
`ICI_BW`."""
from repro_torch.roofline.analysis import (HBM_BW, NVLINK_BW, PEAK_FLOPS,
                                           PEAKS, RooflineReport,
                                           build_report,
                                           model_flops_estimate)


def collective_bytes_per_device(cost) -> dict:
    """Operand bytes per collective kind, from a walk's `CompCost`."""
    return {k: int(v) for k, v in cost.coll.items()}


__all__ = ["HBM_BW", "NVLINK_BW", "PEAK_FLOPS", "PEAKS", "RooflineReport",
           "build_report", "collective_bytes_per_device",
           "model_flops_estimate"]
