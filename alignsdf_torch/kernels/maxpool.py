"""Kernel K7: the ResNet stem's 3x3 / stride 2 / pad 1 max pool, forward and
backward, with its plain PyTorch version and the wrappers that launch the
CUDA kernels (``csrc/maxpool.cu``).

Replaces ``alignsdf_tpu/ops/maxpool.py:maxpool_k3s2p1`` (pass kernels
``_run_pass`` and ``_run_bwd_pass``).  The pool is separable: an H pass
``y1[oh, w] = max(x[2oh-1 : 2oh+2, w])`` then a W pass over ``y1``, rows and
columns outside the image left out.  Its gradient is the TPU kernel's, not
``F.max_pool2d``'s: every position equal to a window's maximum receives that
window's gradient, per axis,

    dy1[oh, w] = sum_{ow covers w} [y1[oh, w] == y[oh, ow]] * dy[oh, ow]
    dx[h, w]   = sum_{oh covers h} [x[h, w] == y1[oh, w]] * dy1[oh, w]

where PyTorch and XLA route each window's gradient to its first maximum.
The two differ wherever a window holds a tie, which a post-ReLU activation
of an image with flat regions (an augmented image's black corners) has.
Shapes are PyTorch's NCHW, float32 or bfloat16 (the bf16 encoder's stem,
JAX ``ops/maxpool.py:71-98`` on a bf16 array); the kernels take
NCHW-contiguous tensors and channels-last ones, the layout the encoder's
stem activation has (an NHWC image permuted to NCHW).  On bf16 the forward
is exact (a max); the backward sums each pass's routed cotangents in
float32 and rounds the pass's result to bf16, dy1 and then dx, as the TPU
kernel's two passes write their outputs in x's dtype.

``maxpool_k3s2p1`` is differentiable.  For a CPU tensor it runs the plain
version both ways; for a CUDA tensor it launches the kernels or raises.
``maxpool_forward.launches`` and ``maxpool_backward.launches`` count the
float32 kernels' launches, ``.bf16_launches`` the bf16 kernels'.
"""

from __future__ import annotations

import ctypes

import torch
from torch.nn import functional as F


def pooled_size(n: int) -> int:
    """Output length of one axis: (n + 2 - 3) // 2 + 1."""
    return (n - 1) // 2 + 1


def _pool_last(x: torch.Tensor) -> torch.Tensor:
    """Max over {2o-1, 2o, 2o+1} of the last axis, outside positions left out."""
    on = pooled_size(x.shape[-1])
    xp = F.pad(x, (1, 1), value=float("-inf"))
    return torch.maximum(torch.maximum(xp[..., 0:2 * on:2], xp[..., 1:2 * on + 1:2]),
                         xp[..., 2:2 * on + 2:2])


def _route_last(x: torch.Tensor, p: torch.Tensor, dp: torch.Tensor) -> torch.Tensor:
    """The backward of one pass along the last axis: dx[j] = sum over the
    windows o covering j of [x[j] == p[o]] * dp[o]."""
    n, on = x.shape[-1], p.shape[-1]
    xp = F.pad(x, (1, 1), value=float("-inf"))
    out = torch.zeros_like(xp)
    for k in (0, 1, -1):  # window o's position 2o + k, shifted by the pad
        sl = slice(1 + k, 1 + k + 2 * on, 2)
        out[..., sl] += torch.where(xp[..., sl] == p, dp, torch.zeros_like(dp))
    return out[..., 1:n + 1]


def _h_pass(x: torch.Tensor) -> torch.Tensor:
    return _pool_last(x.transpose(2, 3)).transpose(2, 3)


def _in_layout_of(t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """t in x's memory layout, channels last or NCHW-contiguous, as the
    kernels give their outputs (the layers after the pool then run the
    same kernels behind either version)."""
    cl = not x.is_contiguous() and x.is_contiguous(memory_format=torch.channels_last)
    return t.contiguous(memory_format=torch.channels_last if cl else torch.contiguous_format)


def maxpool_reference(x: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) -> (N, C, (H-1)//2+1, (W-1)//2+1): the H pass, then the W pass."""
    return _in_layout_of(_pool_last(_h_pass(x)), x)


def maxpool_backward_reference(x: torch.Tensor, y: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """dx from x, the pooled y and its gradient dy, with K7's tie routing;
    y1 is recomputed from x, as the kernel does.  The sums in float32, each
    pass's result rounded to x's dtype."""
    dt = x.dtype
    x32, y, dy = x.to(torch.float32), y.to(torch.float32), dy.to(torch.float32)
    y1 = _h_pass(x32)
    dy1 = _route_last(y1, y, dy).to(dt).to(torch.float32)
    dx = _route_last(x32.transpose(2, 3), y1.transpose(2, 3), dy1.transpose(2, 3)).transpose(2, 3)
    return _in_layout_of(dx.to(dt), x)


def _lib():
    from alignsdf_torch.kernels.build import load

    lib = load("maxpool")
    if not getattr(lib, "_typed", False):
        dims = [ctypes.c_int] * 6  # n, c, h, w, channels_last, bf16
        lib.maxpool_fwd.restype = ctypes.c_int
        lib.maxpool_fwd.argtypes = [ctypes.c_void_p] * 2 + dims + [ctypes.c_void_p]
        lib.maxpool_bwd.restype = ctypes.c_int
        lib.maxpool_bwd.argtypes = [ctypes.c_void_p] * 4 + dims + [ctypes.c_void_p]
        lib._typed = True
    return lib


def memory_format(t: torch.Tensor) -> torch.memory_format:
    """The layout K7 runs ``t`` in: NCHW-contiguous, else channels last (an
    NHWC image permuted to NCHW gives cuDNN's convolutions that layout)."""
    if t.is_contiguous():
        return torch.contiguous_format
    if t.dim() == 4 and t.is_contiguous(memory_format=torch.channels_last):
        return torch.channels_last
    raise ValueError(f"K7 takes NCHW-contiguous or channels-last tensors, got strides "
                     f"{t.stride()} for shape {tuple(t.shape)}")


DTYPES = (torch.float32, torch.bfloat16)


def _check(name: str, t: torch.Tensor, shape, fmt: torch.memory_format,
           dtype: torch.dtype) -> None:
    if t.device.type != "cuda" or t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous(memory_format=fmt):
        raise ValueError(f"{name}: K7 takes {dtype} CUDA tensors of shape {tuple(shape)} in "
                         f"{fmt}, got {t.dtype} {tuple(t.shape)} strides {t.stride()} on "
                         f"{t.device}")


def _count(fn, dtype: torch.dtype) -> None:
    if dtype == torch.bfloat16:
        fn.bf16_launches += 1
    else:
        fn.launches += 1


def _run(name: str, fn, device: torch.device, *args) -> None:
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed with code {rc}")


def maxpool_forward(x: torch.Tensor) -> torch.Tensor:
    """K7 forward on the card: y (N, C, OH, OW) in x's layout and dtype
    (float32 or bfloat16)."""
    if x.dim() != 4:
        raise ValueError(f"K7 takes (N, C, H, W), got {tuple(x.shape)}")
    if x.dtype not in DTYPES:
        raise ValueError(f"K7 takes float32 or bfloat16, got {x.dtype}")
    fmt = memory_format(x)
    n, c, h, w = x.shape
    _check("x", x, x.shape, fmt, x.dtype)
    y = torch.empty((n, c, pooled_size(h), pooled_size(w)), dtype=x.dtype,
                    device=x.device, memory_format=fmt)
    _run("maxpool_fwd", _lib().maxpool_fwd, x.device, x.data_ptr(), y.data_ptr(), n, c, h, w,
         int(fmt == torch.channels_last), int(x.dtype == torch.bfloat16))
    _count(maxpool_forward, x.dtype)
    return y


def maxpool_backward(x: torch.Tensor, y: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """K7 backward on the card: dx (N, C, H, W) in x's layout (y and dy in
    the same).  Each thread streams one column (channels last: four
    channels of a pixel, or one where C % 4 != 0; NCHW: one column of a
    plane) down a band of output rows, reading x once; the kernel sets the
    band height."""
    if x.dim() != 4:
        raise ValueError(f"K7 takes (N, C, H, W), got {tuple(x.shape)}")
    if x.dtype not in DTYPES:
        raise ValueError(f"K7 takes float32 or bfloat16, got {x.dtype}")
    fmt = memory_format(x)
    n, c, h, w = x.shape
    pooled = (n, c, pooled_size(h), pooled_size(w))
    _check("x", x, x.shape, fmt, x.dtype)
    _check("y", y, pooled, fmt, x.dtype)
    _check("dy", dy, pooled, fmt, x.dtype)
    dx = torch.empty_like(x, memory_format=fmt)
    _run("maxpool_bwd", _lib().maxpool_bwd, x.device, x.data_ptr(), y.data_ptr(), dy.data_ptr(),
         dx.data_ptr(), n, c, h, w, int(fmt == torch.channels_last),
         int(x.dtype == torch.bfloat16))
    _count(maxpool_backward, x.dtype)
    return dx


maxpool_forward.launches = 0
maxpool_backward.launches = 0
maxpool_forward.bf16_launches = 0
maxpool_backward.bf16_launches = 0


class MaxPoolFunction(torch.autograd.Function):
    """K7 with its own backward: the kernels for a CUDA tensor, the plain
    versions for a CPU one.  Saves x and y; the backward recomputes y1."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        y = maxpool_forward(x) if x.device.type == "cuda" else maxpool_reference(x)
        ctx.save_for_backward(x, y)
        return y

    @staticmethod
    def backward(ctx, dy: torch.Tensor) -> torch.Tensor:
        x, y = ctx.saved_tensors
        if x.device.type == "cuda":
            return maxpool_backward(x, y, dy.to(x.dtype).contiguous(
                memory_format=memory_format(x)))
        return maxpool_backward_reference(x, y, dy)


def maxpool_k3s2p1(x: torch.Tensor) -> torch.Tensor:
    """K7: (N, C, H, W) float32 or bfloat16 -> (N, C, (H-1)//2+1,
    (W-1)//2+1) in x's dtype, differentiable.  Any other dtype raises: the
    pool casts nothing."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"maxpool_k3s2p1 runs on cuda or cpu, not {x.device}")
    if x.dtype not in DTYPES:
        raise NotImplementedError(f"not ported: K7 on {x.dtype} (it takes float32 and "
                                  "bfloat16, as the TPU kernel's callers give it)")
    return MaxPoolFunction.apply(x)
