"""Kernel K6: the generic SDF decoder on materialized [latent, embedding]
rows, its packed plan, its plain PyTorch version and the wrapper that
launches the CUDA kernel (``csrc/generic_decoder.cu``).

Replaces ``alignsdf_tpu/ops/decoder_kernel.py:make_fused_decoder``.  A trunk
is a K1-style ``FoldedTrunk`` whose ``x`` weights multiply the trunk's input
row x0 instead of xyz: layer 0 reads x0 alone, a ``latent_in`` layer l > 0
computes a_{l-1} @ W_x + x0 @ W_in, and ``fin_x`` is a latent_in final
layer's W_in.  The plan pads the hidden widths to the kernel's 256-feature
chunks and the input rows to x0_pad (a multiple of 32) in the weights only:
the kernel reads the rows at their own width and zero-fills the tail in
shared memory, so the TPU's ``pad_inputs`` (:1385) has no counterpart.

``generic_decode`` takes the plain version only for a plan on the CPU; for a
plan on the GPU it launches the kernel or raises.  ``generic_decode.launches``
counts kernel launches: one per call, both trunks.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from alignsdf_torch.kernels.grid_decoder import (
    MAX_SMEM,
    N_ROWS,
    PAD,
    FoldedTrunk,
    HiddenLayer,
    _round_up,
    output_rows,
    pack_trunks,
)

_TILE_P, _BK = 32, 32


@dataclass
class GenericPlan:
    """Trunks packed into one float32 buffer in K6's layout.

    ``desc`` is the int32 descriptor ``generic_decoder.cu`` reads:
    [n_trunks, fin_b, max_pad, n_rows, x0_pad, then per trunk n_hidden, fin,
    fin_x, last_pad, then per hidden layer w, x, b, in_pad, out_pad]
    (offsets in floats, -1 = absent).  ``in_widths`` are the trunks' true
    input widths."""

    flat: torch.Tensor
    desc: np.ndarray
    in_widths: Tuple[int, ...]

    @property
    def device(self) -> torch.device:
        return self.flat.device

    @property
    def n_rows(self) -> int:
        return int(self.desc[3])

    @property
    def x0_pad(self) -> int:
        return int(self.desc[4])

    def view(self, off: int, shape: Tuple[int, ...]) -> torch.Tensor:
        return self.flat[off:off + int(np.prod(shape))].view(shape)

    def trunks(self):
        """Yield (hidden [(w|None, x|None, b)], fin, fin_x|None) views."""
        d = self.desc.tolist()
        n_rows, x0_pad = self.n_rows, self.x0_pad
        pos = 5
        for _ in range(d[0]):
            n_hidden, fin, fin_x, last_pad = d[pos:pos + 4]
            pos += 4
            hidden = []
            for _ in range(n_hidden):
                w, x, b, in_pad, out_pad = d[pos:pos + 5]
                pos += 5
                hidden.append((self.view(w, (in_pad, out_pad)) if w >= 0 else None,
                               self.view(x, (x0_pad, out_pad)) if x >= 0 else None,
                               self.view(b, (out_pad,))))
            yield (hidden, self.view(fin, (n_rows, last_pad)),
                   self.view(fin_x, (n_rows, x0_pad)) if fin_x >= 0 else None)

    @property
    def fin_b(self) -> torch.Tensor:
        return self.view(int(self.desc[1]), (self.n_rows,))


def _pad_rows(t: Optional[torch.Tensor], rows: int) -> Optional[torch.Tensor]:
    if t is None:
        return None
    return torch.cat([t, t.new_zeros(rows - t.shape[0], t.shape[1])]) if t.shape[0] < rows else t


def pack_generic_plan(trunks: List[FoldedTrunk], in_widths: Sequence[int]) -> GenericPlan:
    """Pad and pack trunks (``x`` and ``fin_x`` on the input row) into a
    GenericPlan on the trunks' device, with ``output_rows(trunks)`` rows."""
    if len(in_widths) != len(trunks):
        raise ValueError("one input width per trunk")
    n_rows = output_rows(trunks)
    x0_pad = _round_up(max(in_widths), _BK)
    trunks = [t._replace(hidden=[h._replace(x=_pad_rows(h.x, x0_pad)) for h in t.hidden],
                         fin_x=_pad_rows(t.fin_x, x0_pad)) for t in trunks]

    def layer(place, h: HiddenLayer, in_pad: int, out_pad: int) -> List[int]:
        return [place((in_pad, out_pad), h.w) if h.w is not None else -1,
                place((x0_pad, out_pad), h.x) if h.x is not None else -1,
                place((out_pad,), h.b), in_pad, out_pad]

    flat, desc = pack_trunks(trunks, layer, (n_rows, x0_pad), n_rows)
    return GenericPlan(flat, desc, tuple(int(w) for w in in_widths))


def _outputs(out: torch.Tensor):
    """(sdf_h (M, 1), sdf_o (M, 1), logits (M, C) or None) of (n_rows, M) rows."""
    return out[0:1].T, out[1:2].T, (out[N_ROWS:].T if out.shape[0] > N_ROWS else None)


def generic_decode_reference(plan: GenericPlan, x_h: torch.Tensor,
                             x_o: Optional[torch.Tensor] = None):
    """The plain version of K6: the plan's arithmetic step by step with
    torch.matmul.  x_h (M, in_h) and, for twin trunks, x_o (M, in_o).
    Returns (sdf_h (M, 1), sdf_o (M, 1), logits (M, C) or None)."""
    m = x_h.shape[0]
    acc = plan.fin_b[:, None].expand(plan.n_rows, m).clone()
    for (hidden, fin, fin_x), x0 in zip(plan.trunks(), (x_h, x_o)):
        x0 = torch.nn.functional.pad(x0.to(torch.float32), (0, plan.x0_pad - x0.shape[1]))
        a = None
        for w, x, b in hidden:
            h = b[None, :]
            if w is not None:
                h = h + a @ w
            if x is not None:
                h = h + x0 @ x
            a = torch.relu(h)
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
                   ctypes.c_void_p, ctypes.c_void_p]
    return fn


def smem_bytes(max_pad: int, x0_pad: int, n_rows: int = N_ROWS) -> int:
    return 4 * (2 * max_pad * _TILE_P + _BK * PAD + x0_pad * _TILE_P + n_rows * _TILE_P)


def _rows(x: torch.Tensor, width: int, m: int, device: torch.device) -> torch.Tensor:
    if x.dtype != torch.float32 or x.device != device or x.dim() != 2:
        raise ValueError("input rows must be 2-D float32 on the plan's device")
    if x.shape != (m, width):
        raise ValueError(f"input rows {tuple(x.shape)} do not fit ({m}, {width})")
    return x if x.stride(1) == 1 else x.contiguous()


def generic_decode(plan: GenericPlan, x_h: torch.Tensor, x_o: Optional[torch.Tensor] = None):
    """K6: (sdf_h (M, 1), sdf_o (M, 1), logits (M, C) or None) of the
    trunks' input rows x_h and, for twin trunks, x_o."""
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
    x_h = _rows(x_h, plan.in_widths[0], m, plan.device)
    if x_o is not None:
        x_o = _rows(x_o, plan.in_widths[1], m, plan.device)
    if smem_bytes(int(plan.desc[2]), plan.x0_pad, plan.n_rows) > MAX_SMEM:
        raise ValueError(f"hidden width {int(plan.desc[2])} and input width {plan.x0_pad} need "
                         "more shared memory than a block has")
    out = torch.empty((plan.n_rows, m), dtype=torch.float32, device=plan.device)
    desc = np.ascontiguousarray(plan.desc, np.int32)
    xo = x_o if x_o is not None else x_h
    with torch.cuda.device(plan.device):
        stream = torch.cuda.current_stream(plan.device).cuda_stream
        rc = _launcher()(plan.flat.data_ptr(), desc.ctypes.data, int(desc.size),
                         x_h.data_ptr(), int(x_h.stride(0)), int(x_h.shape[1]),
                         xo.data_ptr(), int(xo.stride(0)), int(xo.shape[1]), int(m),
                         out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"generic_decoder launch failed with code {rc}"
                           + (" (plan or rows rejected)" if rc == -1 else ""))
    generic_decode.launches += 1
    return _outputs(out)


generic_decode.launches = 0
