import repro_torch.kernels.ssd_chunk.ops  # noqa: F401 — registers "ssm"
from repro_torch.kernels.ssd_chunk.ref import ssd_scan_ref
from repro_torch.kernels.ssd_chunk.ssd_chunk import (ssd_chunk_scan,
                                                     ssd_chunk_scan_plain)

__all__ = ["ssd_chunk_scan", "ssd_chunk_scan_plain", "ssd_scan_ref"]
