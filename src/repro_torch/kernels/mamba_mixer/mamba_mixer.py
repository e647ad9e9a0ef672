"""Hand-written CUDA kernels: the Mamba2 mixer's pointwise work on either
side of its SSD scan.

- `mamba_conv_silu`: the depthwise causal conv over xBC with its bias and
  SiLU, read from the in_proj output's xBC columns and the conv carry (the
  sequence's K - 1 rows before it) without concatenating them, and
  softplus(dt + dt_bias); xs, B, C and dt come out group-major, (G, B, T,
  ...) fp32, so each group's scan call takes dense slices.
- `gated_rms_norm`: one group's D skip, SiLU(z) gate and gated RMSNorm,
  reading that group's scan output y and xs and the in_proj output's z
  columns, and writing the model dtype into the group's columns of the
  out_proj input.

They replace no TPU kernel: the JAX package computes this work in plain
code, and so did the port's published Zamba2 (some twenty passes over fp32
copies a layer).  Bound on an H100: bytes; the conv moves 6 bytes a
channel and token, the norm 12 (`csrc/mamba_mixer.cu` says how each reads
its rows once).  Both compute in fp32, in the order of the plain versions
(`ref.py`), and round once where the plain versions round.

`next_carry` gives a layer's new conv carry, the last K - 1 rows of
[carry, xBC], as a view of xBC where T >= K - 1.

The kernels take one layout, the one every Zamba2 of the port has: a
4-tap conv and widths (conv_dim, d_inner / G, N, P) in fours.  The
wrappers refuse any other on every device.  For CUDA tensors they launch
the kernels (bf16 activations and weights, fp32 dt_bias, D, y and xs, the
rows and pointers aligned for the kernels' 8- and 16-byte loads) and
raise where they cannot; for CPU tensors they compute the plain versions.
`.launches` on each wrapper counts launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.mamba_mixer.ref import (gated_rms_norm_ref,
                                                 mamba_conv_silu_ref)

#: the conv's taps, the one K the kernel is built for
TAPS = 4
#: tokens one conv thread walks: each input row is read once a run, and
#: the K - 1 rows before a run once more (from L2)
CONV_RUN = 16
#: channels one thread takes, by 8-byte bf16 and 16-byte fp32 loads: the
#: widths come in multiples of it
VEC = 4


def _refuse(kernel: str, why: str) -> None:
    raise ValueError(f"{kernel}: {why}")


def _check_dtypes(kernel: str, device_type: str, activations, fp32) -> None:
    """Activations of one dtype (bf16 on CUDA; bf16 or float32 on the CPU)
    and the fp32 operands float32, all on one device."""
    takes = (torch.bfloat16,) if device_type == "cuda" else (
        torch.bfloat16, torch.float32)
    dtypes = {t.dtype for t in activations.values()}
    if len(dtypes) != 1 or not dtypes <= set(takes):
        raise TypeError(f"{kernel} on {device_type} takes "
                        f"{', '.join(activations)} of one dtype of {takes}, "
                        f"got {[t.dtype for t in activations.values()]}")
    for name, t in fp32.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{kernel}: {name} must be float32, got "
                            f"{t.dtype}")
    devices = {t.device for t in (*activations.values(), *fp32.values())}
    if len(devices) != 1:
        _refuse(kernel, f"operands on {sorted(map(str, devices))}")


def _rows(kernel: str, name: str, t: torch.Tensor) -> Tuple[int, int]:
    """A (B, T, width) operand's (batch, token) strides: the last
    dimension dense.  Raises otherwise."""
    if t.stride(2) != 1 and t.shape[2] > 1:
        _refuse(kernel, f"operand {name} {tuple(t.shape)} with strides "
                        f"{t.stride()} is not dense in its last dimension")
    return t.stride(0), t.stride(1)


def _require_aligned(kernel: str, nbytes: int, **tensors_and_strides):
    """Raises unless every data pointer and every given stride (in bytes)
    is a multiple of `nbytes`."""
    for name, (t, strides) in tensors_and_strides.items():
        elt = t.element_size()
        if t.data_ptr() % nbytes or any((s * elt) % nbytes for s in strides):
            _refuse(kernel, f"operand {name} (address {t.data_ptr():#x}, "
                            f"strides {t.stride()}) is not {nbytes}-byte "
                            f"aligned")


def conv_shapes(xbc, carry, conv_w, conv_b, dt_raw, dt_bias, ngroups: int,
                headdim: int) -> Tuple[int, int, int, int, int, int]:
    """(B, T, conv_dim, K, H, N) of a conv call; raises where the shapes
    do not fit one layout: xbc (B, T, d_inner + 2 G N) with d_inner = H P,
    carry (B, K - 1, conv_dim), conv_w (K, conv_dim), conv_b (conv_dim,),
    dt_raw (B, T, H), dt_bias (H,), G dividing H; K = `TAPS` and d_inner
    / G and N multiples of `VEC`."""
    kernel = "mamba_conv_silu"
    if xbc.dim() != 3 or dt_raw.dim() != 3 or conv_w.dim() != 2:
        _refuse(kernel, f"needs xbc (B, T, conv_dim), dt_raw (B, T, H) and "
                        f"conv_w (K, conv_dim), got {tuple(xbc.shape)}, "
                        f"{tuple(dt_raw.shape)}, {tuple(conv_w.shape)}")
    b, t, conv_dim = xbc.shape
    k, h = conv_w.shape[0], dt_raw.shape[-1]
    d_inner = h * headdim
    n, odd = divmod(conv_dim - d_inner, 2 * ngroups)
    if ngroups < 1 or headdim < 1 or odd or n < 1 or h % ngroups:
        _refuse(kernel, f"conv_dim {conv_dim} is not H {h} x P {headdim} + "
                        f"2 x G {ngroups} x N, or G does not divide H")
    want = {"carry": (b, k - 1, conv_dim), "conv_w": (k, conv_dim),
            "conv_b": (conv_dim,), "dt_raw": (b, t, h), "dt_bias": (h,)}
    got = {"carry": carry, "conv_w": conv_w, "conv_b": conv_b,
           "dt_raw": dt_raw, "dt_bias": dt_bias}
    for name, shape in want.items():
        if tuple(got[name].shape) != shape:
            _refuse(kernel, f"{name} has shape {tuple(got[name].shape)}, "
                            f"want {shape}")
    if k != TAPS:
        _refuse(kernel, f"{k} taps; the kernel takes {TAPS}")
    if (d_inner // ngroups) % VEC or n % VEC:
        _refuse(kernel, f"a group's d_inner {d_inner // ngroups} and N {n} "
                        f"must be multiples of {VEC}")
    return b, t, conv_dim, k, h, n


@functools.lru_cache(maxsize=None)
def _conv_launcher():
    fn = build.load("mamba_mixer").mamba_conv_silu_launch
    fn.argtypes = ([ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 10
                   + [ctypes.c_longlong] * 4 + [ctypes.c_int] * 9
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _norm_launcher():
    fn = build.load("mamba_mixer").gated_rms_norm_launch
    fn.argtypes = ([ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 6
                   + [ctypes.c_longlong] * 4 + [ctypes.c_int] * 4
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def mamba_conv_silu(xbc: torch.Tensor, carry: torch.Tensor,
                    conv_w: torch.Tensor, conv_b: torch.Tensor,
                    dt_raw: torch.Tensor, dt_bias: torch.Tensor, *,
                    ngroups: int, headdim: int
                    ) -> Tuple[torch.Tensor, ...]:
    """The conv, bias and SiLU over [carry, xbc] and softplus(dt_raw +
    dt_bias).  xbc (B, T, conv_dim) and dt_raw (B, T, H) may be strided
    views with a dense last dimension (the in_proj output's columns);
    carry (B, K - 1, conv_dim), conv_w (K, conv_dim), conv_b (conv_dim,)
    in xbc's dtype, dt_bias (H,) float32.  Returns new fp32 tensors xs (G,
    B, T, H / G, P), B and C (G, B, T, N) and dt (G, B, T, H / G)."""
    b, t, conv_dim, k, h, n = conv_shapes(xbc, carry, conv_w, conv_b, dt_raw,
                                          dt_bias, ngroups, headdim)
    _check_dtypes("mamba_conv_silu", xbc.device.type,
                  {"xbc": xbc, "carry": carry, "conv_w": conv_w,
                   "conv_b": conv_b, "dt_raw": dt_raw}, {"dt_bias": dt_bias})
    if xbc.device.type == "cpu":
        return mamba_conv_silu_ref(xbc, carry, conv_w, conv_b, dt_raw,
                                   dt_bias, ngroups=ngroups, headdim=headdim)
    build.require_contiguous("mamba_conv_silu", carry=carry, conv_w=conv_w,
                             conv_b=conv_b, dt_bias=dt_bias)
    x_strides = _rows("mamba_conv_silu", "xbc", xbc)
    d_strides = _rows("mamba_conv_silu", "dt_raw", dt_raw)
    _require_aligned("mamba_conv_silu", 8, xbc=(xbc, x_strides),
                     carry=(carry, ()), conv_w=(conv_w, ()),
                     conv_b=(conv_b, ()))
    g, hg, d_inner = ngroups, h // ngroups, h * headdim
    f32 = dict(dtype=torch.float32, device=xbc.device)
    xs = torch.empty((g, b, t, hg, headdim), **f32)
    bmat = torch.empty((g, b, t, n), **f32)
    cmat = torch.empty((g, b, t, n), **f32)
    dt = torch.empty((g, b, t, hg), **f32)
    dev = xbc.device
    err = _conv_launcher()(
        dev.index, 1, xbc.data_ptr(), carry.data_ptr(), conv_w.data_ptr(),
        conv_b.data_ptr(), dt_raw.data_ptr(), dt_bias.data_ptr(),
        xs.data_ptr(), bmat.data_ptr(), cmat.data_ptr(), dt.data_ptr(),
        *x_strides, *d_strides, b, t, conv_dim, d_inner, g, n, h, k,
        CONV_RUN, torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"mamba_conv_silu launch failed with CUDA error "
                           f"{err} (xbc {tuple(xbc.shape)}, G {g}, N {n}, "
                           f"K {k})")
    mamba_conv_silu.launches += 1
    return xs, bmat, cmat, dt


mamba_conv_silu.launches = 0


def next_carry(carry: torch.Tensor, xbc: torch.Tensor) -> torch.Tensor:
    """The last K - 1 rows of [carry, xbc] (carry (B, K - 1, C), xbc (B,
    T, C)): a view of xbc where T >= K - 1, else a new tensor."""
    k1, t = carry.shape[1], xbc.shape[1]
    if t >= k1:
        return xbc[:, t - k1:]
    return torch.cat([carry[:, t:], xbc], dim=1)


def gated_rms_norm(y: torch.Tensor, xs: torch.Tensor, z: torch.Tensor,
                   d: torch.Tensor, gate: torch.Tensor, out: torch.Tensor,
                   *, eps: float) -> torch.Tensor:
    """One group's out[...] = ((y + d[h] xs) silu(z)) rsqrt(mean + eps)
    gate, the mean of the squares over the group's H / G x P channels.
    y and xs (B, T, H / G, P) float32 contiguous; z and out (B, T, H / G x
    P) in the model dtype, strided views with a dense last dimension (the
    in_proj output's z columns and the out_proj input's columns of the
    group); d (H / G,) float32; gate (H / G x P,) in the model dtype; P
    a multiple of `VEC`.  Writes `out` in place and returns it."""
    kernel = "gated_rms_norm"
    if y.dim() != 4 or z.dim() != 3:
        _refuse(kernel, f"needs y (B, T, H / G, P) and z (B, T, H / G x P), "
                        f"got {tuple(y.shape)}, {tuple(z.shape)}")
    b, t, hg, p = y.shape
    dg = hg * p
    want = {"xs": (b, t, hg, p), "z": (b, t, dg), "d": (hg,),
            "gate": (dg,), "out": (b, t, dg)}
    got = {"xs": xs, "z": z, "d": d, "gate": gate, "out": out}
    for name, shape in want.items():
        if tuple(got[name].shape) != shape:
            _refuse(kernel, f"{name} has shape {tuple(got[name].shape)}, "
                            f"want {shape}")
    if p % VEC:
        _refuse(kernel, f"P {p} must be a multiple of {VEC}")
    _check_dtypes(kernel, y.device.type, {"z": z, "gate": gate, "out": out},
                  {"y": y, "xs": xs, "d": d})
    if y.device.type == "cpu":
        return out.copy_(gated_rms_norm_ref(y, xs, z, d, gate, eps=eps))
    build.require_contiguous(kernel, y=y, xs=xs, d=d, gate=gate)
    z_strides = _rows(kernel, "z", z)
    o_strides = _rows(kernel, "out", out)
    _require_aligned(kernel, 16, y=(y, ()), xs=(xs, ()))
    _require_aligned(kernel, 8, z=(z, z_strides), gate=(gate, ()),
                     out=(out, o_strides))
    dev = y.device
    err = _norm_launcher()(
        dev.index, 1, y.data_ptr(), xs.data_ptr(), z.data_ptr(),
        d.data_ptr(), gate.data_ptr(), out.data_ptr(), *z_strides,
        *o_strides, b, t, dg, p, eps,
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"gated_rms_norm launch failed with CUDA error "
                           f"{err} (y {tuple(y.shape)})")
    gated_rms_norm.launches += 1
    return out


gated_rms_norm.launches = 0

