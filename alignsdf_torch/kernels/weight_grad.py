"""The train backwards' weight-gradient reduction on its own: C = A @ B.T of
two feature-major operands (A (K, m), B (N, m), the points as the reduced
dimension), its plain PyTorch version and the wrapper that launches the
CUDA kernel (``csrc/weight_grad.cu``): float32 operands in split TF32 on
the tensor cores (``csrc/wgrad_tc.cuh``); bf16 operands, the bf16
backwards', on bf16 ``wgmma`` summed in float32, in clusters fed by TMA
multicast (``csrc/wgrad_bf16_tc.cuh``).

The backwards of K2, K4 and K5 launch the same kernels from their own calls
(dW of every layer, dX of the embedding or input row, K4's d(Lat));
replaces the dW and dX accumulation of their TPU kernels
(``alignsdf_tpu/ops/decoder_train_kernel.py:652``, ``:286`` and
``decoder_train_pixel.py:647``).  This entry point serves the tests on the
card and timing the reduction apart from the chains around it:
``weight_grad`` one call, ``weight_grads`` a run of calls launched as a
backward launches them; ``weight_grad_plan`` reports the bf16 launcher's
cluster, chunk and loads.

Both take the plain version only for tensors on the CPU; on the GPU they
launch the kernel or raise.  ``weight_grad.launches`` counts its
launches (not the backwards', which count their own), ``.bf16_launches``
its bf16 ones.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

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
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    return fn


PLAN_KEYS = ("bn", "ck", "cn", "chunk", "chunks", "tma", "a_rows", "b_rows", "a_piece",
             "b_piece", "clusters_fit", "vec_out")


def weight_grad_plan(k: int, n: int, m: int) -> dict:
    """The bf16 launcher's plan for a (K, N) reduction over m points on
    aligned operands, on the current CUDA device: the tile width ``bn``,
    the cluster's ``ck`` x ``cn`` tiles, the ``chunk`` of points a cluster
    sums and how many ``chunks``, whether the stages load by TMA, the rows
    of A and B a stage holds and the piece each loading block multicasts,
    the clusters the card holds at once and whether C takes 16-byte
    atomics."""
    if not (0 < k < 2 ** 31 and 0 < n < 2 ** 31 and 0 < m < 2 ** 31 and m % 4 == 0):
        raise ValueError(f"({k}, {n}) over {m} points is outside the bf16 kernel")
    from alignsdf_torch.kernels.build import load

    fn = load("weight_grad").weight_grad_bf16_plan
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    out = (ctypes.c_int * len(PLAN_KEYS))()
    rc = fn(int(k), int(n), int(m), ctypes.addressof(out))
    if rc != 0:
        raise RuntimeError(f"weight_grad_bf16_plan failed with code {rc}")
    return dict(zip(PLAN_KEYS, out))


def _checked(a: torch.Tensor, b: torch.Tensor, out: Optional[torch.Tensor]) -> None:
    """A ValueError for operands or an out the wrapper refuses."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[1]:
        raise ValueError(f"a {tuple(a.shape)} and b {tuple(b.shape)} are not (K, m) and (N, m)")
    if a.device != b.device or a.dtype != b.dtype or a.dtype not in (torch.float32,
                                                                     torch.bfloat16):
        raise ValueError("a and b must be float32, or both bf16, on one device")
    (k, m), n = a.shape, b.shape[0]
    if out is not None and (out.shape != (k, n) or out.dtype != torch.float32
                            or out.device != a.device or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous ({k}, {n}) float32 tensor on {a.device}")
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"weight_grad runs on cuda or cpu, not {a.device}")
    if a.device.type == "cuda" and not (0 < k < 2 ** 31 and 0 < n < 2 ** 31 and 0 < m < 2 ** 31):
        raise ValueError(f"shapes ({k}, {m}) and ({n}, {m}) are outside the kernel")


def _launch(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor, overlap: bool) -> None:
    """One launch of C += a @ b.T on the card (operands contiguous)."""
    (k, m), n = a.shape, b.shape[0]
    bf16 = a.dtype == torch.bfloat16
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = _launcher()(a.data_ptr(), b.data_ptr(), c.data_ptr(), int(k), int(n), int(m),
                         int(bf16), int(overlap), stream)
    if rc != 0:
        raise RuntimeError(f"weight_grad launch failed with code {rc}")
    if bf16:
        weight_grad.bf16_launches += 1
    else:
        weight_grad.launches += 1


def weight_grad(a: torch.Tensor, b: torch.Tensor,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(K, N) float32 a @ b.T of a (K, m) and b (N, m), both float32 or both
    bf16 (bf16: m a multiple of 4); with ``out``, a contiguous (K, N)
    float32 tensor on their device, a @ b.T is added into it (the
    backwards' contract: C holds zeros or a sum to add to) and out
    returned."""
    _checked(a, b, out)
    if a.device.type == "cpu":
        return weight_grad_reference(a, b) if out is None else out.add_(weight_grad_reference(a, b))
    a, b = a.contiguous(), b.contiguous()
    c = torch.zeros((a.shape[0], b.shape[0]), dtype=torch.float32, device=a.device) \
        if out is None else out
    _launch(a, b, c, overlap=False)
    return c


def weight_grads(pairs: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                 outs: Optional[Sequence[Optional[torch.Tensor]]] = None) -> List[torch.Tensor]:
    """``weight_grad`` of each (a, b) of ``pairs`` (into ``outs[i]`` where
    given), in order, launched as a backward launches its reductions after
    its chain: every operand is complete (made contiguous, each output
    allocated) before the first launch, so each bf16 launch after it may
    start in the tail of the one before (csrc/wgrad_bf16_tc.cuh's
    ``overlap``)."""
    outs = list(outs) if outs is not None else [None] * len(pairs)
    if len(outs) != len(pairs):
        raise ValueError(f"{len(outs)} outs for {len(pairs)} pairs")
    for (a, b), out in zip(pairs, outs):
        _checked(a, b, out)
    if len({a.device for a, _ in pairs}) > 1:
        raise ValueError("a run's operands lie on one device")
    if pairs and pairs[0][0].device.type == "cpu":
        return [weight_grad(a, b, out) for (a, b), out in zip(pairs, outs)]
    pairs = [(a.contiguous(), b.contiguous()) for a, b in pairs]
    cs = [torch.zeros((a.shape[0], b.shape[0]), dtype=torch.float32, device=a.device)
          if out is None else out for (a, b), out in zip(pairs, outs)]
    for i, ((a, b), c) in enumerate(zip(pairs, cs)):
        _launch(a, b, c, overlap=i > 0)
    return cs


weight_grad.launches = 0
weight_grad.bf16_launches = 0
