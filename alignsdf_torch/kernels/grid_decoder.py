"""Kernel K1: the fused SDF grid decoder, its packed plan, its plain PyTorch
version and the wrapper that launches the CUDA kernel.

Replaces ``alignsdf_tpu/ops/decoder_kernel.py:make_fused_grid_kernel_t``
and its points-major sibling ``make_fused_grid_kernel``.  For a run of ``m``
contiguous linear grid indices from ``base`` (z fastest) it derives xyz,
runs the latent-folded trunks and returns an (n_rows, m) float32 array: row
0 the hand SDF, row 1 the object SDF (both tanh'd), rows 2.. the
classifier's logits, which the plan packs as extra final rows of the hand
trunk (``ops/grid_plan.py``).  The CUDA source is ``csrc/grid_decoder.cu``.

``grid_decode`` takes the plain version only for a plan on the CPU; for a
plan on the GPU it launches the kernel or raises.  ``grid_decode.launches``
counts kernel launches.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

PAD = 256     # hidden widths pad to the kernel's output chunk
ALIGN = 64    # every array of the packed plan starts on a 256-byte boundary
N_ROWS = 2      # SDF rows: hand, object (tanh'd)
MAX_ROWS = 128  # SDF rows and up to 126 classes
MAX_SMEM = 232448
_TILE_P, _BK, _MAX_TRUNKS, _MAX_HIDDEN = 32, 32, 2, 8


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


class HiddenLayer(NamedTuple):
    """One folded hidden layer: relu(b + a @ w + xyz @ x)."""

    w: Optional[torch.Tensor]  # (in, out); None for layer 0, whose input is folded
    x: Optional[torch.Tensor]  # (3, out) or None
    b: torch.Tensor            # (out,)


class FoldedTrunk(NamedTuple):
    """A latent-folded trunk: hidden layers, then ``fin @ a + fin_x @ xyz +
    fin_b`` written to output ``rows``."""

    hidden: List[HiddenLayer]
    fin: torch.Tensor              # (last_in, len(rows)), columns in row order
    fin_x: Optional[torch.Tensor]  # (3, len(rows)) or None
    fin_b: torch.Tensor            # (len(rows),)
    rows: Sequence[int]


@dataclass
class GridPlan:
    """Folded trunks packed into one float32 buffer in the kernel's layout.

    ``desc`` is the int32 layout descriptor ``grid_decoder.cu`` reads:
    [n_trunks, fin_b, max_pad, n_rows, then per trunk n_hidden, fin,
    fin_xyz, last_pad, then per hidden layer w, x, b, in_pad, out_pad]
    (offsets in floats, -1 = absent).  Hidden weights are (in_pad, out_pad)
    with out contiguous; xyz weights (3, out_pad); final rows (n_rows,
    last_pad), every trunk holding all of them (zeros in the rows it does
    not write).
    """

    flat: torch.Tensor
    desc: np.ndarray
    n: int

    @property
    def device(self) -> torch.device:
        return self.flat.device

    def view(self, off: int, shape: Tuple[int, ...]) -> torch.Tensor:
        size = int(np.prod(shape))
        return self.flat[off:off + size].view(shape)

    @property
    def n_rows(self) -> int:
        return int(self.desc[3])

    def trunks(self):
        """Yield (hidden [(w|None, x|None, b)], fin, fin_xyz|None) views."""
        d = self.desc.tolist()
        n_rows = self.n_rows
        pos = 4
        for _ in range(d[0]):
            n_hidden, fin, fin_xyz, last_pad = d[pos:pos + 4]
            pos += 4
            hidden = []
            for _ in range(n_hidden):
                w, x, b, in_pad, out_pad = d[pos:pos + 5]
                pos += 5
                hidden.append((self.view(w, (in_pad, out_pad)) if w >= 0 else None,
                               self.view(x, (3, out_pad)) if x >= 0 else None,
                               self.view(b, (out_pad,))))
            yield (hidden, self.view(fin, (n_rows, last_pad)),
                   self.view(fin_xyz, (n_rows, 3)) if fin_xyz >= 0 else None)

    @property
    def fin_b(self) -> torch.Tensor:
        return self.view(int(self.desc[1]), (self.n_rows,))


def pack_trunks(trunks: Sequence, place_layer: Callable, head: Sequence[int] = (),
                n_rows: int = N_ROWS) -> Tuple[torch.Tensor, np.ndarray]:
    """Pad and pack trunks (FoldedTrunk-like: ``hidden`` layers with
    ``w``/``b``, ``fin``, ``fin_x``, ``fin_b``, ``rows``) into one zeroed
    float32 buffer on their device, each array starting on an ALIGN
    boundary, with ``n_rows`` final rows.  Returns (flat, desc), desc =
    [n_trunks, fin_b, max_pad, *head, then per trunk n_hidden, fin, fin_xyz,
    last_pad, then per hidden layer ``place_layer(place, layer, in_pad,
    out_pad)``], where ``place(shape, fill)`` reserves an array with
    ``fill`` in its top-left and returns its offset.  A trunk's ``fin_x``
    (k, len(rows)) lands as (n_rows, k): k is 3 xyz columns for K1 and K3,
    the padded input row for K6."""
    if not 1 <= len(trunks) <= _MAX_TRUNKS:
        raise ValueError(f"the kernel takes 1 or 2 trunks, got {len(trunks)}")
    pieces: List[Tuple[int, Tuple[int, ...], torch.Tensor]] = []
    cursor = 0

    def place(shape: Tuple[int, ...], fill: torch.Tensor) -> int:
        nonlocal cursor
        off = cursor
        cursor = _round_up(cursor + int(np.prod(shape)), ALIGN)
        pieces.append((off, shape, fill))
        return off

    device = trunks[0].fin_b.device
    fin_b = torch.zeros(n_rows, dtype=torch.float32, device=device)
    for t in trunks:
        fin_b[list(t.rows)] += t.fin_b
    desc = [len(trunks), place((n_rows,), fin_b), 0, *head]
    max_pad = PAD
    for t in trunks:
        if not 1 <= len(t.hidden) <= _MAX_HIDDEN or t.hidden[0].w is not None:
            raise ValueError("a trunk needs 1-8 hidden layers and a layer 0 whose "
                             "embedding input is folded")
        layers = []
        in_pad = 0
        for h in t.hidden:
            out_pad = _round_up(h.b.shape[0], PAD)
            max_pad = max(max_pad, out_pad, in_pad)
            layers.append(place_layer(place, h, in_pad, out_pad))
            in_pad = out_pad
        fin = torch.zeros(n_rows, t.fin.shape[0], dtype=torch.float32, device=device)
        fin[list(t.rows)] = t.fin.T
        fin_xyz = -1
        if t.fin_x is not None:
            fx = torch.zeros(n_rows, t.fin_x.shape[0], dtype=torch.float32, device=device)
            fx[list(t.rows)] = t.fin_x.T
            fin_xyz = place(tuple(fx.shape), fx)
        desc += [len(t.hidden), place((n_rows, in_pad), fin), fin_xyz, in_pad]
        for layer in layers:
            desc += layer
    desc[2] = max_pad

    flat = torch.zeros(cursor, dtype=torch.float32, device=device)
    for off, shape, fill in pieces:
        dst = flat[off:off + int(np.prod(shape))].view(shape)
        if len(shape) == 1:
            dst[:fill.shape[0]] = fill
        else:
            dst[:fill.shape[0], :fill.shape[1]] = fill
    return flat, np.asarray(desc, np.int32)


def output_rows(trunks: Sequence) -> int:
    """The output rows a grid kernel's plan needs: as many as the highest
    row a trunk writes.  Only the first trunk may write the class rows (>=
    N_ROWS): the kernels (K1, K3) run the others' final layers over the SDF
    rows alone."""
    n_rows = max(N_ROWS, 1 + max(max(t.rows) for t in trunks))
    if n_rows > MAX_ROWS:
        raise ValueError(f"{n_rows} output rows: the kernel writes at most {MAX_ROWS} "
                         f"({MAX_ROWS - N_ROWS} classes)")
    if any(max(t.rows) >= N_ROWS for t in trunks[1:]):
        raise ValueError("only the first trunk may write class rows")
    return n_rows


def pack_grid_plan(trunks: List[FoldedTrunk], n: int) -> GridPlan:
    """Pad and pack folded trunks into a GridPlan on the trunks' device,
    with ``output_rows(trunks)`` output rows."""
    n_rows = output_rows(trunks)

    def layer(place, h: HiddenLayer, in_pad: int, out_pad: int) -> List[int]:
        return [place((in_pad, out_pad), h.w) if h.w is not None else -1,
                place((3, out_pad), h.x) if h.x is not None else -1,
                place((out_pad,), h.b), in_pad, out_pad]

    return GridPlan(*pack_trunks(trunks, layer, (n_rows,), n_rows), n)


def grid_coords(base: int, m: int, n: int, origin: torch.Tensor,
                voxel: torch.Tensor) -> torch.Tensor:
    """(m, 3) xyz of linear indices base..base+m (x slowest, z fastest)."""
    idx = base + torch.arange(m, device=origin.device, dtype=torch.int64)
    ijk = torch.stack([idx // (n * n) % n, idx // n % n, idx % n], dim=1)
    return ijk.to(torch.float32) * voxel + origin[None, :]


def grid_decode_reference(plan: GridPlan, base: int, m: int, origin: torch.Tensor,
                          voxel: torch.Tensor) -> torch.Tensor:
    """The plain version of K1: the same folded-plan arithmetic with
    torch.matmul.  Returns (n_rows, m) float32, tanh on the SDF rows."""
    xyz = grid_coords(base, m, plan.n, origin, voxel)
    acc = plan.fin_b[:, None].expand(plan.n_rows, m).clone()
    for hidden, fin, fin_xyz in plan.trunks():
        a = None
        for w, x, b in hidden:
            h = b[None, :]
            if w is not None:
                h = h + a @ w
            if x is not None:
                h = h + xyz @ x
            a = torch.relu(h)
        acc = acc + fin @ a.T
        if fin_xyz is not None:
            acc = acc + fin_xyz @ xyz.T
    return torch.cat([torch.tanh(acc[:N_ROWS]), acc[N_ROWS:]])


def _launcher():
    from alignsdf_torch.kernels.build import load

    lib = load("grid_decoder")
    fn = lib.grid_decoder_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p]
    return fn


def smem_bytes(max_pad: int, n_rows: int = N_ROWS) -> int:
    return 4 * (2 * max_pad * _TILE_P + _BK * PAD + 3 * _TILE_P + n_rows * _TILE_P)


def grid_decode(plan: GridPlan, base: int, m: int, origin: torch.Tensor,
                voxel: torch.Tensor) -> torch.Tensor:
    """K1: (n_rows, m) float32 SDFs (and logits) of grid indices
    base..base+m."""
    if plan.device.type == "cpu":
        return grid_decode_reference(plan, base, m, origin, voxel)
    if plan.device.type != "cuda":
        raise ValueError(f"grid_decode runs on cuda or cpu, not {plan.device}")
    if plan.flat.dtype != torch.float32 or not plan.flat.is_contiguous():
        raise ValueError("the plan must be contiguous float32")
    if plan.flat.data_ptr() % 16:
        raise ValueError("the plan buffer must be 16-byte aligned")
    if m <= 0 or base < 0 or base + m > plan.n ** 3 or plan.n ** 3 >= 2 ** 31:
        raise ValueError(f"index run [{base}, {base + m}) outside the {plan.n}^3 grid")
    if smem_bytes(int(plan.desc[2]), plan.n_rows) > MAX_SMEM:
        raise ValueError(f"hidden width {int(plan.desc[2])} needs more shared memory "
                         "than a block has")
    scal = torch.cat([torch.as_tensor(origin, dtype=torch.float32).reshape(3),
                      torch.as_tensor(voxel, dtype=torch.float32).reshape(1)]
                     ).to(plan.device).contiguous()
    out = torch.empty((plan.n_rows, m), dtype=torch.float32, device=plan.device)
    desc = np.ascontiguousarray(plan.desc, np.int32)
    with torch.cuda.device(plan.device):
        stream = torch.cuda.current_stream(plan.device).cuda_stream
        rc = _launcher()(plan.flat.data_ptr(), desc.ctypes.data, int(desc.size),
                         scal.data_ptr(), int(base), int(m), int(plan.n), out.data_ptr(),
                         stream)
    if rc != 0:
        raise RuntimeError(f"grid_decoder launch failed with code {rc}"
                           + (" (plan rejected)" if rc == -1 else ""))
    grid_decode.launches += 1
    return out


grid_decode.launches = 0
