"""Kernel K1: the fused SDF grid decoder, its packed plan, its plain PyTorch
version and the wrapper that launches the CUDA kernel.

Replaces ``alignsdf_tpu/ops/decoder_kernel.py:make_fused_grid_kernel_t``
and its points-major sibling ``make_fused_grid_kernel``.  For a run of ``m``
contiguous linear grid indices from ``base`` (z fastest) it derives xyz,
runs the latent-folded trunks and returns an (n_rows, m) float32 array: row
0 the hand SDF, row 1 the object SDF (both tanh'd), rows 2.. the
classifier's logits, which the plan packs as extra final rows of the hand
trunk (``ops/grid_plan.py``).  The CUDA source is ``csrc/grid_decoder.cu``,
in float32 on the tensor-core trunk of ``csrc/grid_trunk_tc.cuh`` that K3
shares: the plan stores each hidden layer's weights split into TF32 halves,
big and small, as tiles of 128 outputs x 8 k in that trunk's shared-memory
layout (``tile_weights``).

A plan packed with ``dtype=torch.bfloat16`` serves the JAX package's bf16
grid kernel (``make_fused_grid_decode_fn(..., dtype=jnp.bfloat16)``) on its
own kernel, ``grid_bf16_kernel`` in ``csrc/grid_trunk_bf16_tc.cuh``, and in
its layout (``pack_grid_plan_bf16``): each trunk one stream of the items
that kernel's ring carries, in its order, each hidden layer in halves of up
to 256 outputs (each k step's tile of 16 k, then the half's bias and
bf16-rounded xyz weights in float32), then the final rows as bf16 tiles;
the kernel rounds each hidden activation to bf16 after the ReLU.  The plain
version emulates that in float32: the same roundings, so its products are
exact and its sums float32.

``grid_decode`` takes the plain version only for a plan on the CPU; for a
plan on the GPU it launches the kernel or raises.  ``grid_decode.launches``
counts kernel launches.  ``grid_decode.bf16_launches`` counts the bf16
kernel's (a bf16 plan's) launches apart.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, field
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

PAD = 256     # the train decoders' hidden widths pad to a multiple of this (K2, K4, K5)
ALIGN = 64    # every array of the packed plan starts on a 256-byte boundary
N_ROWS = 2      # SDF rows: hand, object (tanh'd)
MAX_ROWS = 128  # SDF rows and up to 126 classes
MAX_SMEM = 232448
_MAX_TRUNKS, _MAX_HIDDEN = 2, 8
# grid_trunk_tc.cuh (K1, K3, K6): hidden widths pad to its output group,
# wgmma's N, at most 4 groups; a weight tile is TC_GROUP outputs x TC_K k
TC_GROUP = 128
TC_K = 8
TC_K_BF16 = 16  # a bf16 tile's k depth: wgmma's K for bf16
TC_MAX_OUT = 512
TC_SLOTS = 11  # the trunk's ring of tiles
# grid_trunk_bf16_tc.cuh (K1 and K6 in bf16): 128 points a block in clusters of 2,
# a layer's outputs in halves of up to 256 (wgmma's N), 8 KB ring slots
GB_P = 128
GB_CLUSTER = 2
GB_HALF = 256
GB_SLOT = 8192
GB_SCRATCH = 32768  # a warpgroup's scratch: half of a layer's outputs for 64 points
GB_PLAN_KEYS = ("smem_bytes", "points_a_block", "cluster", "grid_blocks", "ring_slots",
                "stream_bytes")
DTYPES = (torch.float32, torch.bfloat16)  # a plan's compute dtype


def check_dtype(dtype: torch.dtype) -> torch.dtype:
    if dtype not in DTYPES:
        raise ValueError(f"the grid kernels compute in float32 or bfloat16, not {dtype}")
    return dtype


def k_step(dtype: torch.dtype) -> int:
    """A plan's k step: its depths and input rows pad to a multiple of it."""
    return TC_K_BF16 if check_dtype(dtype) == torch.bfloat16 else TC_K


def round_to(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` rounded to ``dtype`` (to nearest, ties to even), in x's own
    dtype (float32, or float64 for a float64 reference): the values a bf16
    plan or trunk computes with."""
    if check_dtype(dtype) == torch.float32:
        return x
    return x.to(torch.bfloat16).to(x.dtype)


def tile_floats(k: int, out_pad: int, dtype: torch.dtype = torch.float32) -> int:
    """float32 words the (k, out_pad) tiles take: two TF32 halves, or bf16
    pairs."""
    return 2 * k * out_pad if check_dtype(dtype) == torch.float32 else k * out_pad // 2


def tc_smem_bytes(rows: int) -> int:
    """grid_trunk_tc.cuh's tc_smem_bytes: the ring, ``rows`` x 64 activations,
    xyz, two SDF rows, 256 floats of scratch, the ring's barriers."""
    return 4 * (TC_SLOTS * 2 * TC_GROUP * TC_K + rows * 64 + 3 * 64 + 2 * 64 + 256) + 8 * TC_SLOTS


# the most activation rows (a multiple of TC_K) a block's shared memory
# holds beside the ring: 544
TC_MAX_ROWS = max(r for r in range(0, 1024, TC_K) if tc_smem_bytes(r) <= MAX_SMEM)


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
    [n_trunks, fin_b, rows, n_rows, then per trunk n_hidden, fin, fin_xyz,
    last_pad, then per hidden layer w, x, b, in_pad, out_pad] (offsets in
    floats, -1 = absent; rows = the activation buffer's, the widest layer).
    Hidden weights (in_pad, out_pad) are stored as ``tile_weights`` tiles;
    a layer's bias and xyz weights as one ``epilogue_tile`` at b (x = b +
    TC_MAX_OUT, or -1); final rows (n_rows, last_pad), every trunk holding
    all of them (zeros in the rows it does not write).
    """

    flat: torch.Tensor
    desc: np.ndarray
    n: int
    dtype: torch.dtype = field(default=torch.float32, kw_only=True)

    _HEAD = 4   # desc entries before the first trunk
    _LAYER = 5  # desc entries a hidden layer

    @property
    def device(self) -> torch.device:
        return self.flat.device

    def view(self, off: int, shape: Tuple[int, ...]) -> torch.Tensor:
        size = int(np.prod(shape))
        return self.flat[off:off + size].view(shape)

    def xyz_weights(self, off: int, out_pad: int) -> torch.Tensor:
        """The (3, out_pad) xyz weights of an epilogue tile (rows TC_MAX_OUT
        apart)."""
        return self.view(off, (3, TC_MAX_OUT))[:, :out_pad]

    def weights(self, off: int, k: int, out_pad: int) -> torch.Tensor:
        """The (k, out_pad) weights whose tiles start at ``off``, big +
        small or bf16, in float32 (a copy)."""
        return untile_weights(self.flat[off:off + tile_floats(k, out_pad, self.dtype)], k,
                              out_pad, self.dtype)

    @property
    def n_rows(self) -> int:
        return int(self.desc[3])

    def trunks(self):
        """Yield (hidden [(w|None, x|None, b)], fin, fin_xyz|None): views,
        but w untiled (a copy); a bf16 plan's all copies."""
        if self.dtype == torch.bfloat16:
            yield from self._bf16_trunks()
            return
        d = self.desc.tolist()
        n_rows = self.n_rows
        pos = self._HEAD
        for _ in range(d[0]):
            n_hidden, fin, fin_xyz, last_pad = d[pos:pos + 4]
            pos += 4
            hidden = []
            for _ in range(n_hidden):
                w, x, b, in_pad, out_pad = d[pos:pos + 5]
                pos += 5
                hidden.append((self.weights(w, in_pad, out_pad) if w >= 0 else None,
                               self.xyz_weights(x, out_pad) if x >= 0 else None,
                               self.view(b, (out_pad,))))
            yield (hidden, self.view(fin, (n_rows, last_pad)),
                   self.view(fin_xyz, (n_rows, 3)) if fin_xyz >= 0 else None)

    def _bf16_trunks(self):
        """trunks() of pack_grid_plan_bf16's layout: each layer's halves
        walked in stream order, untiled and joined."""
        d = self.desc.tolist()
        n_rows = self.n_rows
        pos = self._HEAD
        for t in range(d[0]):
            n_hidden, fin, fin_xyz, last_pad = d[pos:pos + 4]
            pos += 4
            hidden = []
            for _ in range(n_hidden):
                w, x, b, in_pad, out_pad = d[pos:pos + 5]
                pos += 5
                cursor, ws, xs, bs = (w if w >= 0 else b), [], [], []
                for width in half_widths(out_pad)[::-1]:  # streamed last half first
                    if w >= 0:
                        size = tile_floats(in_pad, width, torch.bfloat16)
                        ws.insert(0, untile_bf16(self.flat[cursor:cursor + size], in_pad, width))
                        cursor += size
                    rows = self.flat[cursor:cursor + width * (4 if x >= 0 else 1)].view(-1, width)
                    bs.insert(0, rows[0])
                    if x >= 0:
                        xs.insert(0, rows[1:])
                    cursor += rows.numel()
                hidden.append((torch.cat(ws, dim=1) if ws else None,
                               torch.cat(xs, dim=1) if xs else None, torch.cat(bs)))
            nf = fin_width(n_rows if t == 0 else N_ROWS)
            tiles = untile_bf16(self.flat[fin:fin + last_pad * nf // 2], last_pad, nf).T
            rows = tiles.new_zeros(n_rows, last_pad)
            rows[:min(nf, n_rows)] = tiles[:n_rows]
            yield (hidden, rows, self.view(fin_xyz, (n_rows, 3)) if fin_xyz >= 0 else None)

    @property
    def fin_b(self) -> torch.Tensor:
        return self.view(int(self.desc[1]), (self.n_rows,))

    def out_pads(self) -> List[int]:
        """Every hidden layer's padded width (its last desc entry)."""
        d = self.desc.tolist()
        pads, pos = [], self._HEAD
        for _ in range(d[0]):
            n_hidden = d[pos]
            pos += 4
            for _ in range(n_hidden):
                pos += self._LAYER
                pads.append(d[pos - 1])
        return pads


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (10 mantissa bits), ties away from
    zero: cvt.rna.tf32.f32."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_split(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(big, small): big = tf32(w), small = tf32(w - big); big + small is w
    to 2^-22 of |w|."""
    big = tf32_round(w)
    return big, tf32_round(w - big)


def tile_halves(halves: torch.Tensor) -> torch.Tensor:
    """(2, k, out_pad) TF32 halves of a weight matrix, big then small (k a
    multiple of TC_K, out_pad of TC_GROUP; any strides: a transposed view
    will do), as grid_trunk_tc.cuh's tiles,
    flat: for each k step of TC_K (major) and each group of TC_GROUP
    outputs one tile, big then small, each half laid out [8 outputs][k
    half][output][4 k], i.e. core matrices of 8 outputs x 16 bytes: the
    shared-memory image of one wgmma B operand, K-major, without swizzle.
    One copy."""
    _, k, out_pad = halves.shape
    # (half, step, k half, k, group, output group of 8, output) -> (step,
    # group, half, output group of 8, k half, output, k)
    return (halves.unflatten(2, (out_pad // TC_GROUP, TC_GROUP // 8, 8))
            .unflatten(1, (k // TC_K, 2, 4)).permute(1, 4, 0, 5, 2, 6, 3).reshape(-1))


def tile_weights(w: torch.Tensor, k: int, out_pad: int,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(k, out_pad) weights, ``w`` in the top-left and zeros elsewhere, split
    into TF32 halves and laid out as ``tile_halves``; or, for bfloat16,
    rounded to bf16 as tiles of TC_GROUP outputs x 16 k, each the
    shared-memory image of one bf16 wgmma B operand (K-major, core matrices
    of 8 outputs x 8 k, [8 outputs][k half][output][8 k]), in the same
    order (k step major, then output group), as float32 words holding bf16
    pairs."""
    kk = k_step(dtype)
    if k % kk or out_pad % TC_GROUP:
        raise ValueError(f"a ({k}, {out_pad}) tiling needs k % {kk} == 0 and "
                         f"out_pad % {TC_GROUP} == 0")
    if dtype == torch.bfloat16:  # a k step's groups side by side: one tile of out_pad
        return tile_bf16(w, k, out_pad)
    full = w.new_zeros(k, out_pad, dtype=torch.float32)
    full[:w.shape[0], :w.shape[1]] = w
    return tile_halves(torch.stack(tf32_split(full)))


def tile_bf16(w: torch.Tensor, k: int, width: int) -> torch.Tensor:
    """(k, width) weights, ``w`` in the top-left and zeros elsewhere,
    rounded to bf16 as one tile a k step of 16: the shared-memory image of a
    bf16 wgmma B operand of ``width`` outputs (K-major core matrices of 8
    outputs x 8 k: [outputs / 8][k half][output][8 k]), as float32 words
    holding bf16 pairs.  ``tile_weights``' bf16 tiles are these at the
    layer's width: a k step's 128-output tiles side by side."""
    if k % TC_K_BF16 or width % 8:
        raise ValueError(f"a ({k}, {width}) bf16 tiling needs k % 16 == 0 and width % 8 == 0")
    full = w.new_zeros(k, width, dtype=torch.float32)
    full[:w.shape[0], :w.shape[1]] = w
    # (step, k half, k, output group of 8, output) -> (step, group, k half, output, k)
    tiles = full.unflatten(1, (width // 8, 8)).unflatten(0, (k // TC_K_BF16, 2, 8))
    return tiles.permute(0, 3, 1, 4, 2).to(torch.bfloat16).reshape(-1).view(torch.float32)


def untile_bf16(flat: torch.Tensor, k: int, width: int) -> torch.Tensor:
    """(k, width) float32 weights from ``tile_bf16``'s tiles."""
    tiles = flat.contiguous().view(torch.bfloat16).view(k // TC_K_BF16, width // 8, 2, 8, 8)
    return tiles.permute(0, 2, 4, 1, 3).reshape(k, width).to(torch.float32)


def half_widths(out_pad: int) -> List[int]:
    """The bf16 K1's halves of a layer's outputs: up to GB_HALF each."""
    return [min(GB_HALF, out_pad - c) for c in range(0, out_pad, GB_HALF)]


def fin_width(rows: int) -> int:
    """The bf16 K1's final-rows product width for ``rows`` output rows: the
    least of 8, 16, 32, 64, 128 that holds them."""
    return next(w for w in (8, 16, 32, 64, 128) if w >= rows)


def epilogue_tile(b: torch.Tensor, x: Optional[torch.Tensor],
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """A layer's bias and (3, out) xyz weights as one tile of the trunk's
    ring (2 TC_GROUP TC_K floats): the bias at 0, xyz row r at (r + 1)
    TC_MAX_OUT, zeros elsewhere; the xyz weights rounded to ``dtype``, the
    bias not."""
    tile = b.new_zeros(4, TC_MAX_OUT, dtype=torch.float32)
    tile[0, :b.shape[0]] = b
    if x is not None:
        tile[1:, :x.shape[1]] = round_to(x.to(torch.float32), dtype)
    return tile.reshape(-1)


def place_tc_layer(place: Callable, w: Optional[torch.Tensor], lat: Optional[torch.Tensor],
                   x: Optional[torch.Tensor], b: torch.Tensor, in_pad: int, out_pad: int,
                   lat_pad: int, dtype: torch.dtype = torch.float32,
                   xyz_dtype: Optional[torch.dtype] = None) -> List[int]:
    """One hidden layer in grid_trunk_tc.cuh's layout with per-point input
    rows (K3's latent, K6's input row): [w, x, lat, b, in_pad, out_pad].
    ``w`` (in, out) on the activation and ``lat`` (C, out) on the input rows
    are one run of ``tile_weights`` tiles in ``dtype``, lat's (padded to
    lat_pad rows) right after w's; the bias and xyz weights ``x`` (3, out),
    rounded to ``xyz_dtype`` (default ``dtype``), one ``epilogue_tile``.
    ``place(shape, fill)`` reserves an array and returns its offset."""
    parts = []
    if w is not None:
        parts.append(tile_weights(w, in_pad, out_pad, dtype))
    if lat is not None:
        parts.append(tile_weights(lat, lat_pad, out_pad, dtype))
    w_off = lat_off = -1
    if parts:
        tiles = torch.cat(parts)
        off = place(tuple(tiles.shape), tiles)
        w_off = off if w is not None else -1
        if lat is not None:
            lat_off = off + (tile_floats(in_pad, out_pad, dtype) if w is not None else 0)
    epi = epilogue_tile(b, x, xyz_dtype or dtype)
    b_off = place(tuple(epi.shape), epi)
    return [w_off, b_off + TC_MAX_OUT if x is not None else -1, lat_off, b_off, in_pad, out_pad]


def untile_weights(flat: torch.Tensor, k: int, out_pad: int,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(k, out_pad) float32 weights from ``tile_weights``'s tiles: big +
    small, or the bf16 values."""
    if check_dtype(dtype) == torch.bfloat16:
        return untile_bf16(flat, k, out_pad)
    tiles = flat.view(k // TC_K, out_pad // TC_GROUP, 2, TC_GROUP // 8, 2, 8, 4)
    both = tiles[:, :, 0] + tiles[:, :, 1]
    return both.permute(0, 3, 5, 1, 2, 4).reshape(k, out_pad)


def pack_trunks(trunks: Sequence, place_layer: Callable, head: Sequence[int] = (),
                n_rows: int = N_ROWS, pad: int = PAD, dtype: torch.dtype = torch.float32,
                fin_x_dtype: Optional[torch.dtype] = None,
                fin_lat_at: Optional[int] = None) -> Tuple[torch.Tensor, np.ndarray]:
    """Pad and pack trunks (FoldedTrunk-like: ``hidden`` layers with
    ``w``/``b``, ``fin``, ``fin_x``, ``fin_b``, ``rows``) into one zeroed
    float32 buffer on their device, each array starting on an ALIGN
    boundary, hidden widths padded to multiples of ``pad``, with ``n_rows``
    final rows.  Returns (flat, desc), desc =
    [n_trunks, fin_b, max_pad, *head, then per trunk n_hidden, fin, fin_xyz,
    last_pad, then per hidden layer ``place_layer(place, layer, in_pad,
    out_pad)``], where ``place(shape, fill)`` reserves an array with
    ``fill`` in its top-left and returns its offset.  A trunk's ``fin_x``
    (k, len(rows)) lands as (n_rows, k): k is 3 xyz columns for K1 and K3,
    the input row padded to lat_pad for K6.  ``dtype`` rounds the final
    rows' weights ``fin`` (and ``fin_x``, unless ``fin_x_dtype`` says
    otherwise), not their bias.  With ``fin_lat_at`` (K3), trunk t's
    ``fin_lat`` (k, len(rows)), a latent_in final layer's latent weights,
    lands as (n_rows, k) rounded to ``dtype``, its offset (-1 = none) at
    desc[fin_lat_at + t], a slot of ``head``."""
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
    max_pad = pad
    for index, t in enumerate(trunks):
        if not 1 <= len(t.hidden) <= _MAX_HIDDEN or t.hidden[0].w is not None:
            raise ValueError("a trunk needs 1-8 hidden layers and a layer 0 whose "
                             "embedding input is folded")
        layers = []
        in_pad = 0
        for h in t.hidden:
            out_pad = _round_up(h.b.shape[0], pad)
            max_pad = max(max_pad, out_pad, in_pad)
            layers.append(place_layer(place, h, in_pad, out_pad))
            in_pad = out_pad
        fin = torch.zeros(n_rows, t.fin.shape[0], dtype=torch.float32, device=device)
        fin[list(t.rows)] = round_to(t.fin.T.to(torch.float32), dtype)
        fin_xyz = -1
        if t.fin_x is not None:
            fx = torch.zeros(n_rows, t.fin_x.shape[0], dtype=torch.float32, device=device)
            fx[list(t.rows)] = round_to(t.fin_x.T.to(torch.float32), fin_x_dtype or dtype)
            fin_xyz = place(tuple(fx.shape), fx)
        fin_lat = getattr(t, "fin_lat", None)
        if fin_lat_at is not None and fin_lat is not None:
            fl = torch.zeros(n_rows, fin_lat.shape[0], dtype=torch.float32, device=device)
            fl[list(t.rows)] = round_to(fin_lat.T.to(torch.float32), dtype)
            desc[fin_lat_at + index] = place(tuple(fl.shape), fl)
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


def pack_grid_plan(trunks: List[FoldedTrunk], n: int,
                   dtype: torch.dtype = torch.float32) -> GridPlan:
    """Pad and pack folded trunks into a GridPlan on the trunks' device,
    with ``output_rows(trunks)`` output rows, computing in ``dtype``
    (float32: split TF32 tiles; bfloat16: bf16 tiles, the xyz and final
    weights rounded to bf16, the biases float32)."""
    if check_dtype(dtype) == torch.bfloat16:
        return pack_grid_plan_bf16(trunks, n)
    n_rows = output_rows(trunks)

    def layer(place, h: HiddenLayer, in_pad: int, out_pad: int) -> List[int]:
        tiles = tile_weights(h.w, in_pad, out_pad, dtype) if h.w is not None else None
        w = place(tuple(tiles.shape), tiles) if tiles is not None else -1
        epi = epilogue_tile(h.b, h.x, dtype)
        b = place(tuple(epi.shape), epi)
        return [w, b + TC_MAX_OUT if h.x is not None else -1, b, in_pad, out_pad]

    return GridPlan(*pack_trunks(trunks, layer, (n_rows,), n_rows, TC_GROUP, dtype), n,
                    dtype=check_dtype(dtype))


class FlatBuffer:
    """The bf16 packings' float32 buffer, built in order: each placed array
    starts on an ALIGN boundary."""

    def __init__(self):
        self.pieces: List[torch.Tensor] = []
        self.cursor = 0

    def place(self, fill: torch.Tensor) -> int:
        off = self.cursor
        self.pieces.append(fill.reshape(-1))
        self.cursor = _round_up(self.cursor + fill.numel(), ALIGN)
        self.pieces.append(fill.new_zeros(self.cursor - off - fill.numel()))
        return off

    def tensor(self) -> torch.Tensor:
        return torch.cat(self.pieces)


def summed_fin_b(trunks: Sequence, n_rows: int) -> torch.Tensor:
    """The final rows' bias: each trunk's added into the rows it writes."""
    fin_b = torch.zeros(n_rows, dtype=torch.float32, device=trunks[0].fin_b.device)
    for t in trunks:
        fin_b[list(t.rows)] += t.fin_b
    return fin_b


def pack_grid_plan_bf16(trunks: List[FoldedTrunk], n: int) -> GridPlan:
    """Pack folded trunks for the bf16 K1 (``csrc/grid_trunk_bf16_tc.cuh``).
    The descriptor is the float32 plan's ([n_trunks, fin_b, rows, n_rows,
    per trunk n_hidden, fin, fin_xyz, last_pad, per hidden layer w, x, b,
    in_pad, out_pad]); each trunk's arrays are one contiguous stream, in the
    order that kernel's ring carries them: per hidden layer (widths padded to
    TC_GROUP) and half of up to GB_HALF outputs, the last half first, the
    half's k-step tiles
    (``tile_bf16`` of its columns of W; none for layer 0), then its epilogue
    block (the bias, then the xyz weights' x, y and z rows rounded to bf16,
    float32); then the final rows' ``tile_bf16`` tiles, ``fin_width`` wide
    (the first trunk's every row, the others' SDF rows).  w, b and x point at
    a layer's first streamed half (x = b + its width), fin at the final tiles;
    fin_xyz (n_rows, 3) and fin_b (n_rows,) lie apart, as in the float32
    plan."""
    dtype = torch.bfloat16
    n_rows = output_rows(trunks)
    buf = FlatBuffer()
    place = buf.place
    device = trunks[0].fin_b.device
    desc = [len(trunks), place(summed_fin_b(trunks, n_rows)), 0, n_rows]
    max_pad = TC_GROUP
    for index, t in enumerate(trunks):
        if not 1 <= len(t.hidden) <= _MAX_HIDDEN or t.hidden[0].w is not None:
            raise ValueError("a trunk needs 1-8 hidden layers and a layer 0 whose "
                             "embedding input is folded")
        stream, layers, in_pad = [], [], 0
        for h in t.hidden:
            out_pad = _round_up(h.b.shape[0], TC_GROUP)
            if out_pad > TC_MAX_OUT:
                raise ValueError(f"a hidden layer of {h.b.shape[0]} outputs: the bf16 kernel "
                                 f"takes at most {TC_MAX_OUT}")
            max_pad = max(max_pad, out_pad)
            b = h.b.new_zeros(out_pad, dtype=torch.float32)
            b[:h.b.shape[0]] = h.b
            x = None
            if h.x is not None:
                x = h.b.new_zeros(3, out_pad, dtype=torch.float32)
                x[:, :h.x.shape[1]] = round_to(h.x.to(torch.float32), dtype)
            # the halves last first: the one streamed first never writes rows the
            # layer still reads where in_pad <= GB_HALF (grid_trunk_bf16_tc.cuh (a))
            halves = list(zip(range(0, out_pad, GB_HALF), half_widths(out_pad)))[::-1]
            w_off = sum(map(torch.numel, stream)) if h.w is not None else -1
            for c, width in halves:
                if h.w is not None:
                    stream.append(tile_bf16(h.w[:, c:c + width], in_pad, width))
                if c == halves[0][0]:
                    b_off = sum(map(torch.numel, stream))
                rows = b[None, c:c + width] if x is None else torch.cat([b[None, c:c + width],
                                                                         x[:, c:c + width]])
                stream.append(rows.reshape(-1))
            layers.append((w_off, b_off + halves[0][1] if x is not None else -1, b_off, in_pad,
                           out_pad))
            in_pad = out_pad
        nf = fin_width(n_rows if index == 0 else N_ROWS)
        fin = torch.zeros(n_rows, in_pad, dtype=torch.float32, device=device)
        fin[list(t.rows), :t.fin.shape[0]] = round_to(t.fin.T.to(torch.float32), dtype)
        fin_at = sum(map(torch.numel, stream))
        stream.append(tile_bf16(fin[:nf].T, in_pad, nf))
        base = place(torch.cat(stream))
        fin_xyz = -1
        if t.fin_x is not None:
            fx = torch.zeros(n_rows, 3, dtype=torch.float32, device=device)
            fx[list(t.rows)] = round_to(t.fin_x.T.to(torch.float32), dtype)
            fin_xyz = place(fx)
        desc += [len(t.hidden), base + fin_at, fin_xyz, in_pad]
        for w_off, x_off, b_off, i_pad, o_pad in layers:
            desc += [base + w_off if w_off >= 0 else -1, base + x_off if x_off >= 0 else -1,
                     base + b_off, i_pad, o_pad]
    desc[2] = max_pad
    return GridPlan(buf.tensor(), np.asarray(desc, np.int32), n, dtype=dtype)


def bf16_stream_bytes(plan: GridPlan) -> int:
    """The bytes of the items the bf16 K1 streams through its ring for one
    tile of GB_P points: every trunk's stream (from its layer 0 to the end
    of its final tiles)."""
    d = plan.desc.tolist()
    pos, total = GridPlan._HEAD, 0
    for t in range(d[0]):
        n_hidden, fin, _, last_pad = d[pos:pos + 4]
        start = d[pos + 4 + 2]  # layer 0's b: the stream's first item
        nf = fin_width(plan.n_rows if t == 0 else N_ROWS)
        total += 4 * (fin - start) + last_pad // TC_K_BF16 * nf * 32
        pos += 4 + GridPlan._LAYER * n_hidden
    return total


def bf16_launch_model(stream: int, m: int) -> dict:
    """A launch of grid_trunk_bf16_tc.cuh's kernels over m points whose
    tile streams ``stream`` bytes, in Python: points a block, blocks a
    cluster, the clusters' tiles of GB_CLUSTER x GB_P points, and the tile
    bytes the clusters read from L2 (each cluster reads a tile's stream once
    for its GB_CLUSTER x GB_P points; modelled, not measured)."""
    tiles = -(-m // (GB_CLUSTER * GB_P))
    return {"points_a_block": GB_P, "cluster": GB_CLUSTER, "cluster_tiles": tiles,
            "stream_bytes": stream, "l2_tile_bytes": stream * tiles}


def grid_bf16_plan(plan: GridPlan, m: int) -> dict:
    """The bf16 K1's launch for a run of m points (``bf16_launch_model``).
    On the card the launcher's own plan is ``grid_bf16_card_plan``."""
    return bf16_launch_model(bf16_stream_bytes(plan), m)


def gb_scratch(device: torch.device) -> torch.Tensor:
    """The scratch of grid_trunk_bf16_tc.cuh's kernels: GB_SCRATCH bytes for
    each warpgroup of their grid (at most a block an SM)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return torch.empty(sms * 2 * GB_SCRATCH, dtype=torch.uint8, device=device)


def grid_bf16_card_plan(plan: GridPlan, base: int, m: int) -> dict:
    """The launcher's own plan for a run of m points (``GB_PLAN_KEYS``;
    needs the card): its shared memory, points a block, cluster, grid
    blocks, ring slots and a tile's stream bytes."""
    lib = _library()
    fn = lib.grid_decoder_bf16_plan
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    desc = np.ascontiguousarray(plan.desc, np.int32)
    out = (ctypes.c_int * 7)()
    rc = fn(desc.ctypes.data, int(desc.size), int(base), int(m), int(plan.n), out)
    if rc != 0:
        raise RuntimeError(f"grid_decoder_bf16_plan failed with code {rc}")
    v = list(out)
    return dict(zip(GB_PLAN_KEYS, v[:5] + [v[5] + (v[6] << 31)]))


def grid_coords(base: int, m: int, n: int, origin: torch.Tensor,
                voxel: torch.Tensor) -> torch.Tensor:
    """(m, 3) xyz of linear indices base..base+m (x slowest, z fastest)."""
    idx = base + torch.arange(m, device=origin.device, dtype=torch.int64)
    ijk = torch.stack([idx // (n * n) % n, idx // n % n, idx % n], dim=1)
    return ijk.to(torch.float32) * voxel + origin[None, :]


def grid_decode_reference(plan: GridPlan, base: int, m: int, origin: torch.Tensor,
                          voxel: torch.Tensor) -> torch.Tensor:
    """The plain version of K1: the same folded-plan arithmetic with
    torch.matmul (a bf16 plan's hidden activations rounded to bf16 after
    the ReLU).  Returns (n_rows, m) float32, tanh on the SDF rows."""
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
            a = round_to(torch.relu(h), plan.dtype)
        acc = acc + fin @ a.T
        if fin_xyz is not None:
            acc = acc + fin_xyz @ xyz.T
    return torch.cat([torch.tanh(acc[:N_ROWS]), acc[N_ROWS:]])


def _library():
    from alignsdf_torch.kernels.build import load

    return load("grid_decoder")


def _launcher():
    fn = _library().grid_decoder_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
    return fn


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
    scal = torch.cat([torch.as_tensor(origin, dtype=torch.float32).reshape(3),
                      torch.as_tensor(voxel, dtype=torch.float32).reshape(1)]
                     ).to(plan.device).contiguous()
    out = torch.empty((plan.n_rows, m), dtype=torch.float32, device=plan.device)
    desc = np.ascontiguousarray(plan.desc, np.int32)
    bf16 = plan.dtype == torch.bfloat16
    scratch = gb_scratch(plan.device) if bf16 else None
    with torch.cuda.device(plan.device):
        stream = torch.cuda.current_stream(plan.device).cuda_stream
        rc = _launcher()(plan.flat.data_ptr(), desc.ctypes.data, int(desc.size),
                         scal.data_ptr(), int(base), int(m), int(plan.n), out.data_ptr(),
                         int(bf16), scratch.data_ptr() if bf16 else None,
                         scratch.numel() if bf16 else 0, stream)
    if rc != 0:
        raise RuntimeError(f"grid_decoder launch failed with code {rc}"
                           + (" (plan rejected)" if rc == -1 else ""))
    if bf16:
        grid_decode.bf16_launches += 1
    else:
        grid_decode.launches += 1
    return out


grid_decode.launches = 0
grid_decode.bf16_launches = 0  # the bf16 kernel's (a bf16 plan's) launches
