"""The train backwards' weight-gradient reduction on its own: C = A @ B.T of
two feature-major operands (A (K, m), B (N, m), the points as the reduced
dimension), its plain PyTorch version and the wrapper that launches the
CUDA kernel (``csrc/weight_grad.cu`` over ``csrc/wgrad_tc.cuh``, split
TF32 on the tensor cores for float32 operands; bf16 operands, K2's bf16
backward's, on bf16 ``wgmma``, summed in float32).

The backwards of K2, K4 and K5 launch the same kernel from their own calls
(dW of every layer, dX of the embedding or input row, K4's d(Lat));
replaces the dW and dX accumulation of their TPU kernels
(``alignsdf_tpu/ops/decoder_train_kernel.py:652``, ``:286`` and
``decoder_train_pixel.py:647``).  This entry point serves the tests on the
card and timing the reduction apart from the chains around it.

``weight_grad`` takes the plain version only for tensors on the CPU; on the
GPU it launches the kernel or raises.  ``weight_grad.launches`` counts its
launches (not the backwards', which count their own), ``.bf16_launches``
its bf16 ones.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch


def weight_grad_reference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The plain version: (K, N) float32 a @ b.T (bf16 operands' exact
    products, float32 sums)."""
    return a.to(torch.float32) @ b.to(torch.float32).T


def _launcher():
    from alignsdf_torch.kernels.build import load

    lib = load("weight_grad")
    fn = lib.weight_grad_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    return fn


def weight_grad(a: torch.Tensor, b: torch.Tensor,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(K, N) float32 a @ b.T of a (K, m) and b (N, m), both float32 or both
    bf16 (bf16: m a multiple of 4); with ``out``, a contiguous (K, N)
    float32 tensor on their device, a @ b.T is added into it (the
    backwards' contract: C holds zeros or a sum to add to) and out
    returned."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[1]:
        raise ValueError(f"a {tuple(a.shape)} and b {tuple(b.shape)} are not (K, m) and (N, m)")
    if a.device != b.device or a.dtype != b.dtype or a.dtype not in (torch.float32,
                                                                     torch.bfloat16):
        raise ValueError("a and b must be float32, or both bf16, on one device")
    bf16 = a.dtype == torch.bfloat16
    (k, m), n = a.shape, b.shape[0]
    if out is not None and (out.shape != (k, n) or out.dtype != torch.float32
                            or out.device != a.device or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous ({k}, {n}) float32 tensor on {a.device}")
    if a.device.type == "cpu":
        return weight_grad_reference(a, b) if out is None else out.add_(weight_grad_reference(a, b))
    if a.device.type != "cuda":
        raise ValueError(f"weight_grad runs on cuda or cpu, not {a.device}")
    if not (0 < k < 2 ** 31 and 0 < n < 2 ** 31 and 0 < m < 2 ** 31):
        raise ValueError(f"shapes ({k}, {m}) and ({n}, {m}) are outside the kernel")
    a, b = a.contiguous(), b.contiguous()
    c = torch.zeros((k, n), dtype=torch.float32, device=a.device) if out is None else out
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = _launcher()(a.data_ptr(), b.data_ptr(), c.data_ptr(), int(k), int(n), int(m),
                         int(bf16), stream)
    if rc != 0:
        raise RuntimeError(f"weight_grad launch failed with code {rc}")
    if bf16:
        weight_grad.bf16_launches += 1
    else:
        weight_grad.launches += 1
    return c


weight_grad.launches = 0
weight_grad.bf16_launches = 0
