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
(``build_branch_plan(..., dtype)``, :59-110) on its own kernel,
``generic_bf16_kernel`` (K1's bf16 design, ``csrc/grid_trunk_bf16_tc.cuh``,
with the input rows as k steps of their own), in that kernel's layout
(``pack_generic_plan_bf16``): hidden widths and the input row padded to 16,
each trunk one stream of the items its ring carries, bf16 tiles, the final
rows' weights rounded to bf16, float32 biases; its rows enter as bf16 and
the kernel rounds each hidden activation to bf16.  The plain version
emulates it in float32.

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
    GB_HALF,
    GB_PLAN_KEYS,
    N_ROWS,
    TC_GROUP,
    TC_K_BF16,
    TC_MAX_OUT,
    TC_MAX_ROWS,
    FlatBuffer,
    FoldedTrunk,
    HiddenLayer,
    _MAX_HIDDEN,
    _round_up,
    bf16_launch_model,
    check_dtype,
    fin_width,
    gb_scratch,
    half_widths,
    k_step,
    output_rows,
    pack_trunks,
    place_tc_layer,
    round_to,
    summed_fin_b,
    tile_bf16,
    tile_floats,
    untile_bf16,
    untile_weights,
)


@dataclass
class GenericPlan:
    """Trunks packed into one float32 buffer in K6's layout.

    ``desc`` is the int32 descriptor ``generic_decoder.cu`` reads:
    [n_trunks, fin_b, rows, n_rows, lat_pad, then per trunk n_hidden, fin,
    fin_x, last_pad, then per hidden layer w, x, lat, b, in_pad, out_pad]
    (offsets in floats, -1 = absent, x always; rows = the trunk's activation
    buffer).  float32: a layer's W_x (in_pad, out_pad) and W_in (lat_pad,
    out_pad) are one run of ``tile_weights`` tiles, W_in's from ``lat`` on;
    its bias one ``epilogue_tile`` at b; final rows (n_rows, last_pad) and
    fin_x (n_rows, lat_pad).  bf16: ``pack_generic_plan_bf16``'s streams.
    ``in_widths`` are the trunks' true input widths."""

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
        (copies); a bf16 plan's all copies."""
        if self.dtype == torch.bfloat16:
            yield from self._bf16_trunks()
            return
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

    def _bf16_trunks(self):
        """trunks() of pack_generic_plan_bf16's layout: each layer's halves
        walked in stream order, untiled and joined."""
        d = self.desc.tolist()
        n_rows, lat_pad = self.n_rows, self.lat_pad
        pos = 5
        for t in range(d[0]):
            n_hidden, fin, fin_x, last_pad = d[pos:pos + 4]
            pos += 4
            hidden = []
            for _ in range(n_hidden):
                w, _, lat, b, in_pad, out_pad = d[pos:pos + 6]
                pos += 6
                cursor, ws, xs, bs = (w if w >= 0 else lat), [], [], []
                for width in half_widths(out_pad)[::-1]:  # streamed last half first
                    for off, k, part in ((w, in_pad, ws), (lat, lat_pad, xs)):
                        if off >= 0:
                            size = k * width // 2
                            part.insert(0, untile_bf16(self.flat[cursor:cursor + size], k, width))
                            cursor += size
                    bs.insert(0, self.flat[cursor:cursor + width])
                    cursor += width
                hidden.append((torch.cat(ws, dim=1) if ws else None,
                               torch.cat(xs, dim=1) if xs else None, torch.cat(bs)))
            nf = fin_width(n_rows if t == 0 else N_ROWS)
            rows = []
            for off, k in ((fin, last_pad), (fin_x, lat_pad)):
                if off < 0:
                    rows.append(None)
                    continue
                tiles = untile_bf16(self.flat[off:off + k * nf // 2], k, nf).T
                full = tiles.new_zeros(n_rows, k)
                full[:min(nf, n_rows)] = tiles[:n_rows]
                rows.append(full)
            yield hidden, rows[0], rows[1]

    @property
    def fin_b(self) -> torch.Tensor:
        return self.view(int(self.desc[1]), (self.n_rows,))


def pack_generic_plan(trunks: List[FoldedTrunk], in_widths: Sequence[int],
                      dtype: torch.dtype = torch.float32) -> GenericPlan:
    """Pad and pack trunks (``x`` and ``fin_x`` on the input row) into a
    GenericPlan on the trunks' device, with ``output_rows(trunks)`` rows,
    computing in ``dtype`` (bfloat16: ``pack_generic_plan_bf16``).  The
    activation buffer holds the widest layer, and where it can, a latent_in
    layer's activation and input rows together (at most TC_MAX_ROWS: the
    kernel stages a wider input in chunks)."""
    n_rows = _check_trunks(trunks, in_widths)
    if check_dtype(dtype) == torch.bfloat16:
        return pack_generic_plan_bf16(trunks, in_widths)
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


def _check_trunks(trunks: List[FoldedTrunk], in_widths: Sequence[int]) -> int:
    """The plan's output rows; raises where a packing cannot take the trunks."""
    if len(in_widths) != len(trunks):
        raise ValueError("one input width per trunk")
    n_rows = output_rows(trunks)
    for t in trunks:
        if t.fin_x is not None and bool(t.fin_x[:, [i for i, r in enumerate(t.rows)
                                                    if r >= N_ROWS]].any()):
            raise ValueError("the class rows read no input row")
    return n_rows


def pack_generic_plan_bf16(trunks: List[FoldedTrunk], in_widths: Sequence[int]) -> GenericPlan:
    """Pack trunks for the bf16 K6 (``generic_bf16_kernel``,
    ``csrc/grid_trunk_bf16_tc.cuh``), as ``pack_grid_plan_bf16`` packs K1's.
    The descriptor is the float32 plan's; hidden widths pad to 16 (wgmma's N
    in pieces), the input row to lat_pad, a multiple of 16.  Each trunk's
    arrays are one contiguous stream in the order that kernel's ring carries
    them: per hidden layer and half of up to GB_HALF outputs, the last half
    first, the half's k-step tiles (``tile_bf16`` of its columns of W, then
    of W_in), then its bias (float32); then the final rows' ``tile_bf16``
    tiles, ``fin_width`` wide (the first trunk's every row, the others' SDF
    rows), then a latent_in final layer's W_in tiles (fin_x; zero in the
    class rows).  w, lat and b point at a layer's first streamed half, fin
    and fin_x at their tiles; fin_b (n_rows,) lies apart."""
    dtype = torch.bfloat16
    n_rows = _check_trunks(trunks, in_widths)
    lat_pad = _round_up(max(in_widths), TC_K_BF16)
    buf = FlatBuffer()
    device = trunks[0].fin_b.device
    desc = [len(trunks), buf.place(summed_fin_b(trunks, n_rows)), 0, n_rows, lat_pad]
    max_pad = TC_K_BF16
    for index, t in enumerate(trunks):
        if (not 1 <= len(t.hidden) <= _MAX_HIDDEN or t.hidden[0].w is not None
                or t.hidden[0].x is None):
            raise ValueError("a trunk needs 1-8 hidden layers and a layer 0 on the input row")
        stream: List[torch.Tensor] = []
        layers, in_pad = [], 0

        def at() -> int:
            return sum(map(torch.numel, stream))

        for h in t.hidden:
            out_pad = _round_up(h.b.shape[0], TC_K_BF16)
            if out_pad > TC_MAX_OUT:
                raise ValueError(f"a hidden layer of {h.b.shape[0]} outputs: the bf16 kernel "
                                 f"takes at most {TC_MAX_OUT}")
            max_pad = max(max_pad, out_pad)
            b = h.b.new_zeros(out_pad, dtype=torch.float32)
            b[:h.b.shape[0]] = h.b
            first = {}  # where w, lat and b of the first streamed half start
            for c, width in list(zip(range(0, out_pad, GB_HALF), half_widths(out_pad)))[::-1]:
                for key, m, depth in (("w", h.w, in_pad), ("lat", h.x, lat_pad)):
                    if m is not None:
                        first.setdefault(key, at())
                        stream.append(tile_bf16(m[:, c:c + width], depth, width))
                first.setdefault("b", at())
                stream.append(b[c:c + width])
            layers.append((first.get("w", -1), first.get("lat", -1), first["b"], in_pad, out_pad))
            in_pad = out_pad
        nf = fin_width(n_rows if index == 0 else N_ROWS)

        def fin_tiles(m: torch.Tensor, depth: int) -> torch.Tensor:
            rows = torch.zeros(n_rows, depth, dtype=torch.float32, device=device)
            rows[list(t.rows), :m.shape[0]] = round_to(m.T.to(torch.float32), dtype)
            return tile_bf16(rows[:nf].T, depth, nf)

        fin_at, fx_at = at(), -1
        stream.append(fin_tiles(t.fin, in_pad))
        if t.fin_x is not None:
            fx_at = at()
            stream.append(fin_tiles(t.fin_x, lat_pad))
        base = buf.place(torch.cat(stream))
        desc += [len(t.hidden), base + fin_at, base + fx_at if fx_at >= 0 else -1, in_pad]
        for w_off, lat_off, b_off, i_pad, o_pad in layers:
            desc += [base + w_off if w_off >= 0 else -1, -1,
                     base + lat_off if lat_off >= 0 else -1, base + b_off, i_pad, o_pad]
    desc[2] = max_pad
    return GenericPlan(buf.tensor(), np.asarray(desc, np.int32),
                       tuple(int(w) for w in in_widths), dtype=dtype)


def generic_bf16_stream_bytes(plan: GenericPlan) -> int:
    """The bytes of the items the bf16 K6 streams through its ring for one
    tile of points: per trunk, each layer's halves (their W and W_in k-step
    tiles and bias) and the final rows' (and fin_x's) tiles."""
    d = plan.desc.tolist()
    pos, total, lat_pad = 5, 0, plan.lat_pad
    for t in range(d[0]):
        n_hidden, _, fin_x, last_pad = d[pos:pos + 4]
        pos += 4
        for _ in range(n_hidden):
            w, _, lat, _, in_pad, out_pad = d[pos:pos + 6]
            pos += 6
            steps = (in_pad if w >= 0 else 0) // 16 + (lat_pad // 16 if lat >= 0 else 0)
            total += sum(steps * width * 32 + 4 * width for width in half_widths(out_pad))
        steps = last_pad // 16 + (lat_pad // 16 if fin_x >= 0 else 0)
        total += steps * fin_width(plan.n_rows if t == 0 else N_ROWS) * 32
    return total


def generic_bf16_plan(plan: GenericPlan, m: int) -> dict:
    """The bf16 K6's launch for a run of m rows, in Python (``grid_bf16_plan``'s
    keys: the tile bytes the clusters read from L2 modelled, not measured).
    On the card the launcher's own plan is ``generic_bf16_card_plan``."""
    return bf16_launch_model(generic_bf16_stream_bytes(plan), m)


def generic_bf16_card_plan(plan: GenericPlan, m: int) -> dict:
    """The launcher's own plan for a run of m rows (``GB_PLAN_KEYS``; needs
    the card): its shared memory, points a block, cluster, grid blocks, ring
    slots and a tile's stream bytes."""
    from alignsdf_torch.kernels.build import load

    fn = load("generic_decoder").generic_decoder_bf16_plan
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    desc = np.ascontiguousarray(plan.desc, np.int32)
    out = (ctypes.c_int * 7)()
    rc = fn(desc.ctypes.data, int(desc.size), int(m), out)
    if rc != 0:
        raise RuntimeError(f"generic_decoder_bf16_plan failed with code {rc}")
    v = list(out)
    return dict(zip(GB_PLAN_KEYS, v[:5] + [v[5] + (v[6] << 31)]))


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
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_void_p]
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
    bf16 = plan.dtype == torch.bfloat16
    scratch = gb_scratch(plan.device) if bf16 else None
    with torch.cuda.device(plan.device):
        stream = torch.cuda.current_stream(plan.device).cuda_stream
        rc = _launcher()(plan.flat.data_ptr(), desc.ctypes.data, int(desc.size),
                         x_h.data_ptr(), int(x_h.stride(0)), int(x_h.shape[1]),
                         xo.data_ptr(), int(xo.stride(0)), int(xo.shape[1]), int(m),
                         out.data_ptr(), int(bf16), scratch.data_ptr() if bf16 else None,
                         scratch.numel() if bf16 else 0, stream)
    if rc != 0:
        raise RuntimeError(f"generic_decoder launch failed with code {rc}"
                           + (" (plan or rows rejected)" if rc == -1 else ""))
    if bf16:
        generic_decode.bf16_launches += 1
    else:
        generic_decode.launches += 1
    return _outputs(out)


generic_decode.launches = 0
generic_decode.bf16_launches = 0  # the bf16 kernel's (a bf16 plan's) launches
