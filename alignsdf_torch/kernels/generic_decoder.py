"""Kernel K6: the generic SDF decoder on materialized [latent, embedding]
rows, its packed plan, its plain PyTorch version and the wrapper that
launches the CUDA kernel (``csrc/generic_decoder.cu``).

Replaces ``alignsdf_tpu/ops/decoder_kernel.py:make_fused_decoder``.  A trunk
is a K1-style ``FoldedTrunk`` whose ``x`` weights multiply the trunk's input
row x0 instead of xyz: layer 0 reads x0 alone, a ``latent_in`` layer l > 0
computes a_{l-1} @ W_x + x0 @ W_in, and ``fin_x`` is a latent_in final
layer's W_in.  The kernel runs on the tensor-core trunk of K1 and K3
(``csrc/grid_trunk_tc.cuh``), with x0 in the place of K3's sampled latent:
a layer's W_x and W_in are one run of ``tile_weights`` tiles, W_in's padded
to lat_pad (the widest input row, to a multiple of 8) rows.  The kernel
reads the rows at their own width and zero-fills the tail in shared
memory, so the TPU's ``pad_inputs`` (:1385) has no counterpart.

A plan packed with ``dtype=torch.bfloat16`` is JAX's bf16 ``make_fused_decoder``
(``build_branch_plan(..., dtype)``, :59-110): bf16 tiles, the input row's
weights padded to a multiple of 16, the final rows' weights rounded to bf16,
float32 biases; its rows enter as bf16 and the kernel rounds each hidden
activation to bf16.  The plain version emulates it in float32.

``generic_decode`` takes the plain version only for a plan on the CPU; for a
plan on the GPU it launches the kernel or raises.
``generic_decode.launches`` counts kernel launches: one per call, both
trunks.  ``generic_decode.bf16_launches`` counts the bf16 kernel's (a bf16
plan's) launches apart.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from alignsdf_torch.kernels.grid_decoder import (
    N_ROWS,
    TC_GROUP,
    TC_MAX_ROWS,
    FoldedTrunk,
    HiddenLayer,
    _round_up,
    check_dtype,
    k_step,
    output_rows,
    pack_trunks,
    place_tc_layer,
    round_to,
    tile_floats,
    untile_weights,
)


@dataclass
class GenericPlan:
    """Trunks packed into one float32 buffer in K6's layout.

    ``desc`` is the int32 descriptor ``generic_decoder.cu`` reads:
    [n_trunks, fin_b, rows, n_rows, lat_pad, then per trunk n_hidden, fin,
    fin_x, last_pad, then per hidden layer w, x, lat, b, in_pad, out_pad]
    (offsets in floats, -1 = absent, x always; rows = the trunk's activation
    buffer).  A layer's W_x (in_pad, out_pad) and W_in (lat_pad, out_pad)
    are one run of ``tile_weights`` tiles, W_in's from ``lat`` on; its bias
    one ``epilogue_tile`` at b; final rows (n_rows, last_pad) and fin_x
    (n_rows, lat_pad).  ``in_widths`` are the trunks' true input widths."""

    flat: torch.Tensor
    desc: np.ndarray
    in_widths: Tuple[int, ...]
    dtype: torch.dtype = field(default=torch.float32, kw_only=True)

    @property
    def device(self) -> torch.device:
        return self.flat.device

    @property
    def n_rows(self) -> int:
        return int(self.desc[3])

    @property
    def lat_pad(self) -> int:
        return int(self.desc[4])

    def view(self, off: int, shape: Tuple[int, ...]) -> torch.Tensor:
        return self.flat[off:off + int(np.prod(shape))].view(shape)

    def weights(self, off: int, k: int, out_pad: int) -> torch.Tensor:
        """The (k, out_pad) weights whose tiles start at ``off``, big +
        small or bf16, in float32 (a copy)."""
        return untile_weights(self.flat[off:off + tile_floats(k, out_pad, self.dtype)], k,
                              out_pad, self.dtype)

    def trunks(self):
        """Yield (hidden [(w|None, x|None, b)], fin, fin_x|None): x the
        input-row weights (lat_pad, out_pad); views, but w and x untiled
        (copies)."""
        d = self.desc.tolist()
        n_rows, lat_pad = self.n_rows, self.lat_pad
        pos = 5
        for _ in range(d[0]):
            n_hidden, fin, fin_x, last_pad = d[pos:pos + 4]
            pos += 4
            hidden = []
            for _ in range(n_hidden):
                w, _, lat, b, in_pad, out_pad = d[pos:pos + 6]
                pos += 6
                hidden.append((self.weights(w, in_pad, out_pad) if w >= 0 else None,
                               self.weights(lat, lat_pad, out_pad) if lat >= 0 else None,
                               self.view(b, (out_pad,))))
            yield (hidden, self.view(fin, (n_rows, last_pad)),
                   self.view(fin_x, (n_rows, lat_pad)) if fin_x >= 0 else None)

    @property
    def fin_b(self) -> torch.Tensor:
        return self.view(int(self.desc[1]), (self.n_rows,))


def pack_generic_plan(trunks: List[FoldedTrunk], in_widths: Sequence[int],
                      dtype: torch.dtype = torch.float32) -> GenericPlan:
    """Pad and pack trunks (``x`` and ``fin_x`` on the input row) into a
    GenericPlan on the trunks' device, with ``output_rows(trunks)`` rows,
    computing in ``dtype``.  The activation buffer holds the widest layer,
    and where it can, a latent_in layer's activation and input rows
    together (at most TC_MAX_ROWS: the kernel stages a wider input in
    chunks)."""
    if len(in_widths) != len(trunks):
        raise ValueError("one input width per trunk")
    n_rows = output_rows(trunks)
    for t in trunks:
        if t.fin_x is not None and bool(t.fin_x[:, [i for i, r in enumerate(t.rows)
                                                    if r >= N_ROWS]].any()):
            raise ValueError("the class rows read no input row")
    lat_pad = _round_up(max(in_widths), k_step(dtype))
    rows = 0

    def layer(place, h: HiddenLayer, in_pad: int, out_pad: int) -> List[int]:
        nonlocal rows
        if h.x is not None:
            rows = max(rows, min(TC_MAX_ROWS, (in_pad if h.w is not None else 0) + lat_pad))
        return place_tc_layer(place, h.w, h.x, None, h.b, in_pad, out_pad, lat_pad, dtype)

    trunks = [t._replace(fin_x=None if t.fin_x is None else torch.cat(
        [t.fin_x, t.fin_x.new_zeros(lat_pad - t.fin_x.shape[0], t.fin_x.shape[1])]))
              for t in trunks]
    flat, desc = pack_trunks(trunks, layer, (n_rows, lat_pad), n_rows, TC_GROUP, dtype)
    desc[2] = max(int(desc[2]), rows)
    return GenericPlan(flat, desc, tuple(int(w) for w in in_widths), dtype=check_dtype(dtype))


def _outputs(out: torch.Tensor):
    """(sdf_h (M, 1), sdf_o (M, 1), logits (M, C) or None) of (n_rows, M) rows."""
    return out[0:1].T, out[1:2].T, (out[N_ROWS:].T if out.shape[0] > N_ROWS else None)


def generic_decode_reference(plan: GenericPlan, x_h: torch.Tensor,
                             x_o: Optional[torch.Tensor] = None):
    """The plain version of K6: the plan's arithmetic step by step with
    torch.matmul, on the plan's weights (the hidden ones read back from
    their TF32 halves or bf16 tiles; a bf16 plan's rows and hidden
    activations rounded to bf16).  x_h (M, in_h) and, for twin trunks, x_o
    (M, in_o).  Returns (sdf_h (M, 1), sdf_o (M, 1), logits (M, C) or
    None)."""
    m = x_h.shape[0]
    acc = plan.fin_b[:, None].expand(plan.n_rows, m).clone()
    for (hidden, fin, fin_x), x0 in zip(plan.trunks(), (x_h, x_o)):
        x0 = round_to(x0.to(torch.float32), plan.dtype)
        x0 = torch.nn.functional.pad(x0, (0, plan.lat_pad - x0.shape[1]))
        a = None
        for w, x, b in hidden:
            h = b[None, :]
            if w is not None:
                h = h + a @ w
            if x is not None:
                h = h + x0 @ x
            a = round_to(torch.relu(h), plan.dtype)
        acc = acc + fin @ a.T
        if fin_x is not None:
            acc = acc + fin_x @ x0.T
    return _outputs(torch.cat([torch.tanh(acc[:N_ROWS]), acc[N_ROWS:]]))


def _launcher():
    from alignsdf_torch.kernels.build import load

    lib = load("generic_decoder")
    fn = lib.generic_decoder_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    return fn


def _rows(x: torch.Tensor, width: int, m: int, device: torch.device,
          dtype: torch.dtype) -> torch.Tensor:
    if x.dtype != dtype or x.device != device or x.dim() != 2:
        raise ValueError(f"input rows must be 2-D {dtype} on the plan's device")
    if x.shape != (m, width):
        raise ValueError(f"input rows {tuple(x.shape)} do not fit ({m}, {width})")
    return x if x.stride(1) == 1 else x.contiguous()


def generic_decode(plan: GenericPlan, x_h: torch.Tensor, x_o: Optional[torch.Tensor] = None):
    """K6: (sdf_h (M, 1), sdf_o (M, 1), logits (M, C) or None) of the
    trunks' input rows x_h and, for twin trunks, x_o, in the plan's dtype
    (float32 or bfloat16)."""
    if plan.device.type == "cpu":
        return generic_decode_reference(plan, x_h, x_o)
    if plan.device.type != "cuda":
        raise ValueError(f"generic_decode runs on cuda or cpu, not {plan.device}")
    if plan.flat.dtype != torch.float32 or not plan.flat.is_contiguous():
        raise ValueError("the plan must be contiguous float32")
    if plan.flat.data_ptr() % 16:
        raise ValueError("the plan buffer must be 16-byte aligned")
    n_trunks = int(plan.desc[0])
    if (x_o is None) != (n_trunks == 1):
        raise ValueError(f"a plan of {n_trunks} trunk(s) takes {n_trunks} row set(s)")
    m = x_h.shape[0]
    if not 0 < m < 2 ** 31:
        raise ValueError(f"{m} rows are outside the kernel")
    x_h = _rows(x_h, plan.in_widths[0], m, plan.device, plan.dtype)
    if x_o is not None:
        x_o = _rows(x_o, plan.in_widths[1], m, plan.device, plan.dtype)
    out = torch.empty((plan.n_rows, m), dtype=torch.float32, device=plan.device)
    desc = np.ascontiguousarray(plan.desc, np.int32)
    xo = x_o if x_o is not None else x_h
    with torch.cuda.device(plan.device):
        stream = torch.cuda.current_stream(plan.device).cuda_stream
        rc = _launcher()(plan.flat.data_ptr(), desc.ctypes.data, int(desc.size),
                         x_h.data_ptr(), int(x_h.stride(0)), int(x_h.shape[1]),
                         xo.data_ptr(), int(xo.stride(0)), int(xo.shape[1]), int(m),
                         out.data_ptr(), int(plan.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"generic_decoder launch failed with code {rc}"
                           + (" (plan or rows rejected)" if rc == -1 else ""))
    if plan.dtype == torch.bfloat16:
        generic_decode.bf16_launches += 1
    else:
        generic_decode.launches += 1
    return _outputs(out)


generic_decode.launches = 0
generic_decode.bf16_launches = 0  # the bf16 kernel's (a bf16 plan's) launches
