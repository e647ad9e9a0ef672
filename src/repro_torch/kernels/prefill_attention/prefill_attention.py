"""Hand-written CUDA kernel: causal self-attention of a prefill from an
empty cache, bf16 on the tensor cores.

Every query t of a sequence attends to its keys 0..t (GQA: the H / KV
query heads of one KV head share its K and V).  It replaces no TPU
kernel: the JAX package attends at prefill in plain code
(`repro.models.flash.flash_full` from 2048 tokens, `attention_scores`
below), and the port's plain twin of that path multiplied in fp32 on the
CUDA cores.  The published Zamba2's shared blocks call it at every prompt
length.

Bound on an H100: operations (2 hd T (T + 1) a sequence and head against
8 hd T bytes moved).  Design (`csrc/prefill_attention.cu`): one block per
(batch x head, 128-query block), longest blocks first; Q resident in
shared memory, 64-key tiles of K and V in a 2-stage `cp.async` ring, no
tile past the diagonal loaded; S = Q K^T and O += P V on mma.sync
m16n8k16 in bf16 with fp32 accumulators, O in registers, the running
max, sum and rescale in fp32, P rounded to bf16 only as the value
product's operand.  So it computes in the precision of the plain version
(`ref.py`, which rounds the scores to bf16 and the normalised
probabilities to bf16) or closer to fp32, not bit for bit like it.

`prefill_attention` launches the kernel for CUDA tensors and raises if
it cannot; for CPU tensors it computes `prefill_attention_ref`.
`prefill_attention.launches` counts launches.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.prefill_attention.ref import prefill_attention_ref

#: the head widths the kernel is instantiated for; a narrower head is
#: padded with zero columns up to the next one
WIDTHS = (64, 128, 224, 256)
#: the dtypes each device takes: the kernel's, and the plain version's
DTYPES = {"cuda": (torch.bfloat16,),
          "cpu": (torch.bfloat16, torch.float32)}


def head_width(hd: int) -> int:
    """The instantiated width a head of `hd` runs at."""
    if hd < 16 or hd % 16 or hd > WIDTHS[-1]:
        raise ValueError(f"prefill_attention: head width {hd} is not a "
                         f"multiple of 16 in 16..{WIDTHS[-1]}")
    return next(w for w in WIDTHS if w >= hd)


def check_operands(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   device_type: Optional[str] = None) -> None:
    """Raise where the kernel (on CUDA) or its plain version (on the CPU)
    does not take these operands: q (B, T, H, hd) and k, v (B, T, KV, hd)
    with KV dividing H, hd a multiple of 16 up to 256, one dtype the
    device takes, one device.  `device_type` defaults to q's."""
    device_type = device_type or q.device.type
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape \
            or k.shape[:2] != q.shape[:2] or k.shape[3] != q.shape[3] \
            or q.shape[2] % k.shape[2]:
        raise ValueError(f"prefill_attention needs q (B, T, H, hd) and k, "
                         f"v (B, T, KV, hd) with KV dividing H, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    head_width(q.shape[3])
    takes = DTYPES.get(device_type, ())
    if len({q.dtype, k.dtype, v.dtype}) != 1 or q.dtype not in takes:
        raise TypeError(f"prefill_attention on {device_type} takes q, k and "
                        f"v of one dtype of {takes}, got "
                        f"{[t.dtype for t in (q, k, v)]}")
    if len({q.device, k.device, v.device}) != 1:
        raise ValueError(f"prefill_attention: operands on "
                         f"{[str(t.device) for t in (q, k, v)]}")


def kernel_strides(name: str, t: torch.Tensor):
    """A (B, T, heads, hd) operand's (batch, token, head) strides in
    elements, as the kernel reads them: the last dimension dense, the
    data and every row 16-byte aligned, each stride in 32 bits.  Raises
    otherwise."""
    elt = t.element_size()
    strides = t.stride()[:3]
    if t.stride(3) != 1 or t.data_ptr() % 16 \
            or any((s * elt) % 16 for s in strides) \
            or any(s >= 2 ** 31 for s in strides):
        raise ValueError(f"prefill_attention: operand {name} "
                         f"{tuple(t.shape)} with strides {t.stride()} at "
                         f"{t.data_ptr():#x} is not dense in its last "
                         f"dimension with 16-byte aligned rows")
    return strides


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = build.load("prefill_attention").prefill_attention_launch
    fn.argtypes = ([ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 4
                   + [ctypes.c_int] * 18 + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def prefill_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      *, scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, T, H, hd); k, v: (B, T, KV, hd), any strides with a dense
    last dimension (v may be a view of a fused qkv projection).  Query t
    attends to keys 0..t; scores are scaled by `scale`, 1 / sqrt(hd)
    unless given.  Returns a new (B, T, H, hd) tensor in q's dtype."""
    check_operands(q, k, v)
    if scale is not None and not scale > 0:
        raise ValueError(f"prefill_attention: scale {scale} is not positive")
    if q.device.type == "cpu":
        return prefill_attention_ref(q, k, v, scale=scale)
    b, t, h, hd = q.shape
    out = torch.empty((b, t, h, hd), dtype=q.dtype, device=q.device)
    strides = [s for name, x in (("q", q), ("k", k), ("v", v), ("o", out))
               for s in kernel_strides(name, x)]
    dev = q.device
    err = _launcher()(dev.index, 1, q.data_ptr(), k.data_ptr(),
                      v.data_ptr(), out.data_ptr(), b, t, h, k.shape[2], hd,
                      head_width(hd), *strides,
                      1.0 / math.sqrt(hd) if scale is None else scale,
                      torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"prefill_attention launch failed with CUDA error "
                           f"{err} (q {tuple(q.shape)}, k {tuple(k.shape)})")
    prefill_attention.launches += 1
    return out


prefill_attention.launches = 0
