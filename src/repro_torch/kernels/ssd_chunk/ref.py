"""Plain PyTorch oracle for the chunked SSD kernel: the per-timestep scan
(the port's copy of `repro.kernels.ssd_chunk.ref`)."""
from __future__ import annotations

import torch


def ssd_scan_ref(x, b, c, dt, a, state0):
    """x: (B,T,H,hd); b/c: (B,T,N); dt: (B,T,H); a: (H,); state0:
    (B,H,hd,N) -> (final_state, y)."""
    decay = torch.exp(dt * a)
    s = state0
    ys = []
    for t in range(x.shape[1]):
        upd = dt[:, t, :, None, None] * (x[:, t, :, :, None]
                                         * b[:, t, None, None, :])
        s = decay[:, t, :, None, None] * s + upd
        ys.append(torch.einsum("bhdn,bn->bhd", s, c[:, t]))
    return s, torch.stack(ys, dim=1)
