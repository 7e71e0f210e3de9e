"""Kernel K4: the pixel-aligned train decoder, forward and backward of both
trunks on a per-point latent sampled from the HeadNet feature map, with its
plain PyTorch version and the wrappers that launch the CUDA kernels
(``csrc/pixel_train_decoder.cu``).

Replaces ``alignsdf_tpu/ops/decoder_train_pixel.py:fused_pixel_decoder``
(forward ``_fused_pixel_fwd`` / ``_fwd_kernel``, backward
``_fused_pixel_bwd`` / ``_bwd_kernel``), unbanded and banded
(``PixelTrainStatics.band``, JAX's ``PixelStatic.band``).  Each point's latent is
the bicubic sample of its scene's (HW, C) table at (xp, yp), or the scene's
mean row where ``mask`` is 0; trunk ``t`` then computes, layer by layer,

    acc = a_{l-1} @ W_l (if W_l) + lat @ Lat_l + emb @ X_l (if Lat_l) + b_l

(the last layer too where ``latent_in`` names it, as JAX's kernel takes it:
on the card its rows stay on the CUDA cores, reading the latent residual
and the embedding, and the chain adds dpre_last Lat_last^T into dlat before
the tap stage rounds and scatters it) with ReLU and the hash dropout gate
(``train_decoder.dropout_gate``, layer ``l + layer_offsets[t]``) on hidden
layers and tanh on the last.  The
outputs of the trunks stack as the rows of y.  The forward also gives
``x_last``, the first trunk's last hidden gated activation (the final
layer's input, which the classifier head reads; JAX ``_fused_pixel_fwd``
:431-434), and the backward takes its gradient ``dx_last``, added to that
trunk's final-layer input gradient before the last hidden gate
(``_trunk_backward`` :489-490), as K2 does.

With ``PixelTrainStatics.dtype`` bfloat16 the trunks keep the JAX kernel's
bf16 contract (``_fused_pixel_fwd`` / ``_fused_pixel_bwd`` with ``cdtype``
bfloat16): the weights (W, Lat, X), the table, the mean and the embedding
rounded to bf16 once, the biases float32; each tap weight ky kx formed in
float32 and rounded (``_weight_tile`` :149-182), the latent summed in
float32 and rounded (the bf16 residual), each hidden activation rounded
after ReLU and the gate (the residual, and the next layer's input).  In the
backward every product takes the pre-activation gradient rounded to bf16,
the bias gradients sum it unrounded; the latent's gradient is summed over
the layers and trunks in float32 and rounded before d(table) = wxy dlat,
d(mean) and the taps' dot products with the table, whose Keys derivatives
and separable d(xp) / d(yp) sums stay float32 (:607-640).  Every gradient
leaves float32 and unrounded, as the JAX kernel's outputs do; where the
map is bf16 (a bf16 encoder), autograd through the plan's cast to float32
rounds d(map) once, as JAX's ``fmap.astype(float32)`` does.

``pixel_train_decode`` takes the plain version for a CPU tensor: in float32
autograd through it gives the gradients; in bf16
``PixelTrainDecodeReference`` pairs it with the plain backward, whose
roundings autograd cannot give.  For a CUDA tensor it runs
``PixelTrainDecodeFunction``, whose forward and backward launch the kernels
or raise.  Both run on the tensor cores, as K2's: split TF32 in float32 and
bf16 ``wgmma`` in bf16; the forward (``csrc/train_fwd_tc.cuh``) reads each
layer's [W; Lat] tiles, the backward's chain their transposes
(``train_decoder.layer_tiles``).  ``pixel_train_decode.launches`` counts
float32 forward launches and ``pixel_train_decode_backward.launches``
backward launches: one each per train step, both trunks together;
``.bf16_launches`` counts the bf16 kernels' apart.

The band changes only how the backward's tap stage sums d(table) on the
card (``csrc/pixel_train_decoder.cu``'s header): with ``st.band`` rows, each
64-point tile's scene segments whose taps' rows fit the band
(``tile_band_bounds``, the plain version of the kernel's bounds) sum their
d(table) in a shared-memory window and flush each touched entry once; the
others scatter each tap with a global atomic, as the unbanded kernel does.
The function computed is the same (the plain backward is both routes'
plain version); a band the window cannot hold (``band_rows_max``) raises.
A banded backward counts in ``pixel_train_decode_backward.band_launches``
(``.band_bf16_launches`` in bf16) instead of ``.launches``.
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from alignsdf_torch.kernels.grid_decoder import TC_MAX_OUT, check_dtype, round_to
from alignsdf_torch.kernels.train_decoder import (
    PAD,
    _M32,
    _pad2,
    _ptr,
    _round_up,
    _run,
    dropout_gate,
    gate_threshold,
    layer_tiles,
    tile_stream,
)
from alignsdf_torch.ops.geometry import bicubic_gather, keys_cubic_grad, keys_cubic_taps

EMB_MAX = 64      # embedding columns the kernels read
MAX_LAYERS = 8
MAX_TRUNKS = 2
MAX_OUT = 2       # outputs of a trunk's last layer
TILE = 64        # points a block of the backward chain
# the backward chain's tap stage holds a 64-point tile's (64, c_pad + 1)
# latent gradient and its tap table (26 words a point) at the end of the
# chain's (TC_MAX_OUT, 64) buffer (tap_stage_floats in the .cu)
_tap_stage_floats = lambda c_pad: (TILE * (c_pad + 1) + 3) // 4 * 4 + 26 * TILE  # noqa: E731
MAX_C_PAD = max(c for c in range(PAD, 2048, PAD) if _tap_stage_floats(c) <= TC_MAX_OUT * TILE)
# the band's window (band_rows_max in the .cu): from the ring's start (11
# slots of 2 x 1024 floats, or 22 of 1024 in bf16) to the tap stage's floats
# go 4 x 64 + 4 ints of segment bounds, a list of 16 x 64 cells, and per row
# of the band wf touched flags and wf x BAND_CH window floats
BAND_CH = 16
_BAND_ROOM = 22528 + TC_MAX_OUT * TILE - (4 * TILE + 4) - 16 * TILE

# one trunk's operands: ws[l] (in, out) or None, lats[l] (C, out) or None,
# xs[l] (e, out) or None (present where lats[l] is), bs[l] (out,)
Trunk = Tuple[Sequence[Optional[torch.Tensor]], Sequence[Optional[torch.Tensor]],
              Sequence[Optional[torch.Tensor]], Sequence[torch.Tensor]]


class PixelTrainStatics(NamedTuple):
    """The static structure shared by the trunks, per layer, and the
    feature map's size."""

    n_per_scene: int              # row // n_per_scene is a point's scene
    feat_hw: Tuple[int, int]      # (Hf, Wf) of the map
    has_w: Tuple[bool, ...]       # reads the previous layer's activation
    has_x: Tuple[bool, ...]       # reads the latent and the embedding
    dropout: Tuple[bool, ...]     # hidden layers with dropout
    keep: float
    train: bool
    layer_offsets: Tuple[int, ...]  # per trunk, added to the layer in the gate's hash
    dtype: torch.dtype = torch.float32  # the compute dtype: float32 or bfloat16
    band: Optional[int] = None    # the backward's banded tap stage: its window's rows


def band_rows_max(wf: int, c: int) -> int:
    """The most rows of a ``wf``-column map the backward's band window holds
    beside a ``c``-channel latent's tap stage (either dtype)."""
    return (_BAND_ROOM - _tap_stage_floats(_round_up(c, PAD))) // (wf * (BAND_CH + 1))


def check_band(st: PixelTrainStatics, c: int) -> None:
    """Raise where ``st.band`` is not a band the kernel takes: an int from
    1 to the map's rows and to ``band_rows_max`` (never clamped)."""
    band = st.band
    if band is None:
        return
    hf, wf = st.feat_hw
    if not isinstance(band, int) or isinstance(band, bool) or not 1 <= band <= hf:
        raise ValueError(f"band {band!r}: an int from 1 to the map's {hf} rows")
    most = band_rows_max(wf, c)
    if band > most:
        raise ValueError(f"band {band}: the tap stage's shared memory holds at most {most} rows "
                         f"of a {wf}-column map beside a {c}-channel latent")


def tile_band_bounds(yp: torch.Tensor, mask: torch.Tensor, n_per_scene: int, hf: int,
                     band: int) -> Tuple[torch.Tensor, ...]:
    """The plain version of the banded tap stage's bounds: for each scene
    segment of each 64-point tile (the tile's points of one scene), (tile,
    scene, r0, fits, live), each (S,).  live: the segment has a point in
    the image (mask 1); its rows run from lo = the least floor(yp) of those
    points to hi = the largest, r0 = min(max(lo - 1, 0), hf - band), and it
    fits where min(hi + 2, hf - 1) < r0 + band (JAX's per-block bounds,
    ``decoder_train_pixel.py:976-992``, without the TPU's row alignment).
    A segment that is not live has r0 0 and does not fit."""
    m = yp.shape[0]
    rows = torch.arange(m, device=yp.device)
    key = (rows // TILE) * (m // n_per_scene + 1) + rows // n_per_scene
    seg, inv = torch.unique_consecutive(key, return_inverse=True)
    big = torch.iinfo(torch.int64).max
    y0 = torch.floor(yp).to(torch.int64)
    inside = mask > 0
    lo = torch.full((len(seg),), big, dtype=torch.int64, device=yp.device).scatter_reduce(
        0, inv, torch.where(inside, y0, big), "amin")
    hi = torch.full((len(seg),), -1, dtype=torch.int64, device=yp.device).scatter_reduce(
        0, inv, torch.where(inside, y0, -1), "amax")
    live = hi >= lo
    r0 = torch.where(live, torch.clamp(torch.clamp(lo - 1, min=0), max=hf - band), 0)
    fits = live & (torch.clamp(hi + 2, max=hf - 1) < r0 + band)
    first = torch.zeros_like(seg).scatter_reduce(0, inv, rows, "amin", include_self=False)
    return first // TILE, first // n_per_scene, r0, fits, live


def sample_latent(table: torch.Tensor, mean: torch.Tensor, xp: torch.Tensor, yp: torch.Tensor,
                  mask: torch.Tensor, st: PixelTrainStatics) -> torch.Tensor:
    """(M, C) latent of each point: the 16-tap bicubic sample of its scene's
    (HW, C) table at (xp, yp), or the scene's mean row where mask is 0.  In
    bf16 (``st.dtype``) each tap weight is rounded to bf16 (the table and
    the mean are the caller's) and the sample is rounded after its float32
    sum."""
    b, _, c = table.shape
    hf, wf = st.feat_hw
    sampled = bicubic_gather(table, xp.reshape(b, -1), yp.reshape(b, -1), hf, wf,
                             st.dtype).reshape(-1, c)
    scene = torch.arange(xp.shape[0], device=xp.device) // st.n_per_scene
    return torch.where(mask[:, None] > 0, round_to(sampled, st.dtype), mean[scene])


def pixel_train_decode_reference(table: torch.Tensor, mean: torch.Tensor, xp: torch.Tensor,
                                 yp: torch.Tensor, mask: torch.Tensor, emb: torch.Tensor,
                                 trunks: Sequence[Trunk], seed: int, st: PixelTrainStatics,
                                 acts: Optional[List[List[torch.Tensor]]] = None,
                                 latent: Optional[List[torch.Tensor]] = None
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of K4's forward, step by step with torch.matmul;
    autograd through it is the plain backward.  table (B, HW, C), mean (B,
    C), xp / yp / mask (M,), emb (M, e).  Returns y (rows, M), the trunks'
    tanh'd outputs stacked, and x_last (M, h), the first trunk's last
    hidden gated activation.  ``acts``, if given, receives per trunk each
    hidden layer's gated activation (M, out); ``latent`` the (M, C) latent.
    In bf16 (``st.dtype``) the operands but the biases, the tap weights, the
    latent and each gated activation are rounded to bf16, the arithmetic
    float32 (or the inputs' float64)."""
    dt = check_dtype(st.dtype)
    lat = sample_latent(round_to(table, dt), round_to(mean, dt), xp, yp, mask, st)
    if latent is not None:
        latent.append(lat)
    emb = round_to(emb, dt)
    rows = torch.arange(emb.shape[0], device=emb.device)
    outs, x_last = [], None
    for (ws, lats, xs, bs), offset in zip(trunks, st.layer_offsets):
        trunk_acts: List[torch.Tensor] = []
        x = None
        for layer in range(len(bs)):
            acc = bs[layer]
            if ws[layer] is not None:
                acc = acc + x @ round_to(ws[layer], dt)
            if lats[layer] is not None:
                acc = acc + lat @ round_to(lats[layer], dt) + emb @ round_to(xs[layer], dt)
            if layer == len(bs) - 1:
                outs.append(torch.tanh(acc).T)
                if x_last is None:
                    x_last = x
                break
            x = torch.relu(acc)
            if st.train and st.dropout[layer]:
                x = x * dropout_gate(seed, layer + offset, rows, x.shape[1],
                                     st.keep).to(x.dtype)
            x = round_to(x, dt)
            trunk_acts.append(x)
        if acts is not None:
            acts.append(trunk_acts)
    return torch.cat(outs, dim=0), x_last


def pixel_train_decode_backward_reference(table, mean, xp, yp, mask, emb,
                                          trunks: Sequence[Trunk], st: PixelTrainStatics,
                                          y: torch.Tensor, acts: Sequence[Sequence[torch.Tensor]],
                                          latent: torch.Tensor, dy: torch.Tensor,
                                          dx_last: Optional[torch.Tensor] = None):
    """The plain version of K4's backward, from the kernel's residuals: y and
    dy (rows, M), per trunk the gated activations (M, out), the latent (M,
    C) and x_last's gradient dx_last (M, h) or None.  The gate is recovered
    as (a > 0) * s, s = 1/keep on dropout layers in training (no hash
    replay).  Returns (d(table) (B, HW, C), d(mean) (B, C), d(xp) (M,),
    d(yp) (M,), d(emb), [(dws, dlats, dxs, dbs)] per trunk); d(xp), d(yp)
    come through ``keys_cubic_grad``.  In bf16 every product takes dpre
    rounded to bf16 and the rounded operands (``acts`` and ``latent`` hold
    bf16 values), the bias gradients dpre itself; the latent's gradient is
    rounded before the sampling's gradients, which read the rounded table
    and tap weights (the Keys weights of d(xp), d(yp) unrounded)."""
    dt = check_dtype(st.dtype)
    m, c = latent.shape
    b, hw, _ = table.shape
    hf, wf = st.feat_hw
    emb_c = round_to(emb, dt)
    dlat = torch.zeros_like(latent)
    demb = torch.zeros_like(emb)
    grads = []
    row = 0
    for t, ((ws, lats, xs, bs), trunk_acts) in enumerate(zip(trunks, acts)):
        n_layers, n_out = len(bs), bs[-1].shape[-1]
        dws, dlats, dxs, dbs = ([None] * n_layers for _ in range(4))
        yt = y[row:row + n_out]
        dpre = (dy[row:row + n_out] * (1.0 - yt * yt)).T  # (M, n_out)
        row += n_out
        for layer in range(n_layers - 1, -1, -1):
            dr = round_to(dpre, dt)
            if ws[layer] is not None:
                dws[layer] = trunk_acts[layer - 1].T @ dr
            if lats[layer] is not None:
                dlats[layer] = latent.T @ dr
                dxs[layer] = emb_c.T @ dr
                dlat = dlat + dr @ round_to(lats[layer], dt).T
                demb = demb + dr @ round_to(xs[layer], dt).T
            dbs[layer] = dpre.sum(0)
            if layer > 0:
                scale = 1.0 / st.keep if st.train and st.dropout[layer - 1] else 1.0
                dx = dr @ round_to(ws[layer], dt).T
                if t == 0 and layer == n_layers - 1 and dx_last is not None:
                    dx = dx + dx_last
                dpre = dx * (trunk_acts[layer - 1] > 0).to(dpre.dtype) * np.float32(scale)
        grads.append((dws, dlats, dxs, dbs))

    dlat = round_to(dlat, dt)
    table = round_to(table, dt)
    scene = torch.arange(m, device=emb.device) // st.n_per_scene
    inside = mask > 0
    dmean = torch.zeros_like(mean).index_add_(0, scene, torch.where(inside[:, None], 0.0, dlat))
    x0, y0 = torch.floor(xp), torch.floor(yp)
    wx, wy = keys_cubic_taps(xp - x0), keys_cubic_taps(yp - y0)
    flat = table.reshape(b * hw, c)
    dtable = torch.zeros_like(flat)
    dxp = torch.zeros_like(xp)
    dyp = torch.zeros_like(yp)
    for i in range(4):
        r = y0 + (i - 1)
        gy = -keys_cubic_grad(r - yp)
        for j in range(4):
            col = x0 + (j - 1)
            gx = -keys_cubic_grad(col - xp)
            valid = inside & (r >= 0) & (r < hf) & (col >= 0) & (col < wf)
            idx = torch.where(valid, scene * hw + r.long() * wf + col.long(), 0)
            dw = (flat[idx] * dlat).sum(1)
            dxp = dxp + torch.where(valid, wy[:, i] * gx * dw, 0.0)
            dyp = dyp + torch.where(valid, gy * wx[:, j] * dw, 0.0)
            w = torch.where(valid, round_to(wy[:, i] * wx[:, j], dt), 0.0)
            dtable.index_add_(0, idx, w[:, None] * dlat)
    return dtable.reshape(b, hw, c), dmean, dxp, dyp, demb, grads


# ---------------------------------------------------------------------------
# the CUDA path
# ---------------------------------------------------------------------------

class _PackedTrunk(NamedTuple):
    """One trunk padded in the kernels' layout."""

    w: List[Optional[torch.Tensor]]     # hidden (in_pad, out_pad); last (in_pad, n_out)
    wt: List[Optional[torch.Tensor]]    # the last layer's transpose of w (the forward's)
    lat: List[Optional[torch.Tensor]]   # (c_pad, out_pad)
    x: List[Optional[torch.Tensor]]     # (e, out_pad)
    b: List[torch.Tensor]               # (out_pad,)
    out_pads: List[int]
    n_out: int
    row_off: int
    layer_off: int


class _Packed(NamedTuple):
    """Contiguous float32 copies of every operand, in the kernels' layout (in
    bf16 the weights, the table, the mean and the embedding hold their
    bf16-rounded values)."""

    table: torch.Tensor   # (B, HW, C)
    mean: torch.Tensor    # (B, C)
    xp: torch.Tensor      # (M,)
    yp: torch.Tensor
    mask: torch.Tensor
    emb_t: torch.Tensor   # (e, M)
    trunks: List[_PackedTrunk]
    c_pad: int
    n_rows: int
    chain: torch.Tensor   # the backward chain's weight tiles, trunk by trunk, last layer first
    fwd: torch.Tensor     # the forward's weight tiles, trunk by trunk in layer order
    dtype: torch.dtype = torch.float32       # the kernels' arithmetic
    table16: Optional[torch.Tensor] = None   # bf16: the table as bf16, the taps' operand
    emb16: Optional[torch.Tensor] = None     # bf16: emb_t as bf16, the reduction's dX operand


def _check(table, mean, xp, yp, mask, emb, trunks: Sequence[Trunk], st: PixelTrainStatics) -> int:
    """Raise on what the kernels do not take; returns the number of scenes."""
    m, e = emb.shape
    b, hw, c = table.shape
    hf, wf = st.feat_hw
    check_dtype(st.dtype)
    if hw != hf * wf or mean.shape != (b, c):
        raise ValueError(f"a {hf}x{wf} map needs a (B, {hf * wf}, C) table and a (B, C) mean")
    if not 1 <= len(trunks) <= MAX_TRUNKS or len(trunks) != len(st.layer_offsets):
        raise ValueError(f"the kernels take 1-{MAX_TRUNKS} trunks, one layer offset each")
    if not 1 <= e <= EMB_MAX:
        raise ValueError(f"{e} embedding columns are outside the kernel")
    if m <= 0 or m % 4 or m >= 2 ** 31 or m % st.n_per_scene or m // st.n_per_scene != b:
        raise ValueError(f"M = {m} must be a positive multiple of 4 and B x n_per_scene")
    for ws, lats, xs, bs in trunks:
        n_layers = len(bs)
        if not 2 <= n_layers <= MAX_LAYERS:
            raise ValueError(f"the kernel takes 2-{MAX_LAYERS} layers, got {n_layers}")
        if ws[0] is not None or lats[0] is None or any(w is None for w in ws[1:]):
            raise ValueError("layer 0 reads only the latent and the embedding")
        if any((lat is None) != (x is None) for lat, x in zip(lats, xs)):
            raise ValueError("the latent and the embedding enter the same layers")
        if not 1 <= bs[-1].shape[-1] <= MAX_OUT:
            raise ValueError("the last layer has 1-2 outputs")
        for t in [*ws, *lats, *xs, *bs]:
            if t is not None and (t.dtype != torch.float32 or t.device != emb.device):
                raise ValueError("every operand must be float32 on the embedding's device")
    for t in (table, mean, xp, yp, mask, emb):
        if t.dtype != torch.float32 or t.device != emb.device:
            raise ValueError("every operand must be float32 on the embedding's device")
    return b


def pack_pixel_trunks(table, mean, xp, yp, mask, emb, trunks: Sequence[Trunk],
                      st: PixelTrainStatics) -> _Packed:
    """Padded, contiguous copies of every operand (detached) for the kernels,
    the forward's tiles and the backward chain's, in ``st.dtype`` (bf16: the
    weights, the table, the mean and the embedding rounded, the biases not,
    and bf16 copies of the table and the embedding); raises on what they do
    not take."""
    _check(table, mean, xp, yp, mask, emb, trunks, st)
    dt = st.dtype
    c = table.shape[2]
    c_pad = _round_up(c, PAD)
    if c_pad > MAX_C_PAD:
        raise ValueError(f"a {c}-channel latent is too wide for the backward chain's tile")
    packed, runs, fwd_runs, row = [], [], [], 0
    for (ws, lats, xs, bs), offset in zip(trunks, st.layer_offsets):
        n_layers, n_out = len(bs), bs[-1].shape[-1]
        w, lat, x, b, out_pads = [], [], [], [], []
        in_pad = 0
        for layer in range(n_layers):
            out_pad = n_out if layer == n_layers - 1 else _round_up(bs[layer].shape[-1], PAD)
            pad = lambda t, rows: None if t is None else _pad2(round_to(t, dt), rows, out_pad)  # noqa: E731
            w.append(pad(ws[layer], in_pad))
            lat.append(pad(lats[layer], c_pad))
            x.append(pad(xs[layer], emb.shape[1]))
            b.append(_pad2(bs[layer][None], 1, out_pad)[0])
            out_pads.append(out_pad)
            in_pad = out_pad
        if max(out_pads[:-1]) > TC_MAX_OUT:
            raise ValueError(f"the tensor-core forward and chain take hidden widths up to "
                             f"{TC_MAX_OUT}")
        wt = [None] * (n_layers - 1) + [w[-1].T.contiguous()]
        tiles = [layer_tiles(w[layer], lat[layer], dtype=dt) for layer in range(n_layers - 1)]
        fwd_runs += [t[0] for t in tiles]
        runs += [t[1] for t in reversed(tiles)]
        packed.append(_PackedTrunk(w, wt, lat, x, b, out_pads, n_out, row, offset))
        row += n_out
    f32 = lambda t: t.detach().to(torch.float32).contiguous()  # noqa: E731
    table_c = round_to(f32(table), dt)
    emb_t = round_to(f32(emb.T), dt)
    bf16 = dt == torch.bfloat16
    return _Packed(table_c, round_to(f32(mean), dt), f32(xp), f32(yp), f32(mask), emb_t, packed,
                   c_pad, row, tile_stream(runs, emb.device), tile_stream(fwd_runs, emb.device),
                   dt, table_c.to(torch.bfloat16) if bf16 else None,
                   emb_t.to(torch.bfloat16) if bf16 else None)


def _descriptor(p: _Packed, st: PixelTrainStatics, y, acts, lat, dy=None, demb=None,
                dtable=None, dmean=None, dxp=None, dyp=None, dpre=None, grads=None,
                dx_last=None, dlatent=None, dpre16=None, tile_fit=None) -> np.ndarray:
    """The int64 descriptor ``pixel_train_decoder.cu`` parses (see its host
    side); the band only in a backward's."""
    e, m = p.emb_t.shape
    b, _, c = p.table.shape
    hf, wf = st.feat_hw
    desc = [len(p.trunks), e, m, st.n_per_scene, b, c, p.c_pad, hf, wf,
            _ptr(p.emb_t), _ptr(p.table), _ptr(p.mean), _ptr(p.xp), _ptr(p.yp), _ptr(p.mask),
            _ptr(lat), _ptr(y), _ptr(dy), _ptr(demb), _ptr(dtable), _ptr(dmean), _ptr(dxp),
            _ptr(dyp), _ptr(dx_last), 0 if dx_last is None else dx_last.shape[1],
            _ptr(dlatent), _ptr(p.chain), p.chain.numel(), _ptr(p.fwd), p.fwd.numel(),
            _ptr(p.table16), _ptr(p.emb16), (st.band or 0) if dy is not None else 0,
            _ptr(tile_fit)]
    for t, tr in enumerate(p.trunks):
        n_layers = len(tr.b)
        desc += [n_layers, tr.n_out, tr.row_off, tr.layer_off]
        in_pad = 0
        for layer in range(n_layers):
            dw, dl, dx, db = grads[t][layer] if grads is not None else (None,) * 4
            hidden = layer < n_layers - 1
            desc += [_ptr(tr.w[layer]), _ptr(tr.wt[layer]), _ptr(tr.lat[layer]),
                     _ptr(tr.x[layer]), _ptr(tr.b[layer]),
                     _ptr(acts[t][layer]) if hidden else 0,
                     _ptr(dpre[t][layer]) if dpre is not None else 0,
                     _ptr(dw), _ptr(dl), _ptr(dx), _ptr(db), in_pad, tr.out_pads[layer],
                     int(hidden and st.train and st.dropout[layer]),
                     _ptr(dpre16[t][layer]) if dpre16 is not None else 0]
            in_pad = tr.out_pads[layer]
    return np.ascontiguousarray(desc, np.int64)


def _lib():
    from alignsdf_torch.kernels.build import load

    lib = load("pixel_train_decoder")
    if not getattr(lib, "_typed", False):
        lib.pixel_train_fwd.restype = ctypes.c_int
        lib.pixel_train_fwd.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_uint,
                                        ctypes.c_uint, ctypes.c_float, ctypes.c_int,
                                        ctypes.c_void_p]
        lib.pixel_train_bwd.restype = ctypes.c_int
        lib.pixel_train_bwd.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                                        ctypes.c_int, ctypes.c_void_p]
        lib.pixel_train_band_rows_max.restype = ctypes.c_int
        lib.pixel_train_band_rows_max.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib._typed = True
    return lib


def pixel_train_decode_forward(p: _Packed, seed: int, st: PixelTrainStatics):
    """K4 forward on the card, on the tensor cores
    (``pixel_train_fwd_tc_kernel``, in the pack's dtype): y (rows, M)
    float32, per trunk the gated activations of the hidden layers, each
    (out_pad, M), and the latent (c_pad, M), bf16 on a bf16 pack."""
    e, m = p.emb_t.shape
    dev = p.emb_t.device
    bf16 = p.dtype == torch.bfloat16
    y = torch.empty((p.n_rows, m), dtype=torch.float32, device=dev)
    acts = [[torch.empty((h, m), dtype=p.dtype, device=dev) for h in t.out_pads[:-1]]
            for t in p.trunks]
    lat = torch.empty((p.c_pad, m), dtype=p.dtype, device=dev)
    desc = _descriptor(p, st, y, acts, lat)
    _run("pixel_train_fwd", _lib().pixel_train_fwd, dev, desc.ctypes.data, int(desc.size),
         seed & _M32, gate_threshold(st.keep), float(np.float32(1.0 / st.keep)), int(bf16))
    if bf16:
        pixel_train_decode.bf16_launches += 1
    else:
        pixel_train_decode.launches += 1
    return y, acts, lat


def pixel_train_decode_backward(p: _Packed, st: PixelTrainStatics, y: torch.Tensor,
                                acts: List[List[torch.Tensor]], lat: torch.Tensor,
                                dy: torch.Tensor, dx_last: Optional[torch.Tensor] = None,
                                tile_fit: Optional[torch.Tensor] = None):
    """K4 backward on the card: the reverse chain on the tensor cores
    (adding ``dx_last`` (M, h), if given, to the first trunk's final-layer
    input gradient; the latent's gradient summed in a (c_pad, M) scratch)
    and the sampling's gradients per 64-point tile, then per layer the weight,
    latent-weight, embedding-weight and bias reductions over all M points.
    On a bf16 pack the chain writes each pre-activation gradient twice,
    float32 for the bias sums and rounded to bf16 for the products'
    reductions, and the tap stage rounds the latent's gradient.  With
    ``st.band`` the tap stage takes the band's window where a tile's
    segment fits; given ``tile_fit`` (int32, one a 64-point tile), each
    tile's count of segments that did is written there.
    Returns
    (d(table), d(mean), d(xp), d(yp), d(emb) (M, e), per trunk [(dW | None,
    dLat | None, dX | None, db)] padded)."""
    e, m = p.emb_t.shape
    dev = p.emb_t.device
    bf16 = p.dtype == torch.bfloat16
    dy = dy.to(torch.float32).contiguous()
    if dx_last is not None:
        dx_last = dx_last.to(torch.float32).contiguous()
        if dx_last.shape[0] != m or not 1 <= dx_last.shape[1] <= p.trunks[0].out_pads[-2]:
            raise ValueError(f"dx_last {tuple(dx_last.shape)} does not fit the first trunk")
    demb = torch.empty((m, e), dtype=torch.float32, device=dev)
    dtable = torch.zeros_like(p.table)
    dmean = torch.zeros_like(p.mean)
    dxp = torch.empty_like(p.xp)
    dyp = torch.empty_like(p.yp)
    dpre = [[torch.empty((h, m), dtype=torch.float32, device=dev) for h in t.out_pads]
            for t in p.trunks]
    dpre16 = ([[torch.empty((h, m), dtype=torch.bfloat16, device=dev) for h in t.out_pads]
               for t in p.trunks] if bf16 else None)
    zeros = lambda t: None if t is None else torch.zeros_like(t)  # noqa: E731
    grads = [[(zeros(t.w[layer]), zeros(t.lat[layer]), zeros(t.x[layer]),
               torch.zeros_like(t.b[layer])) for layer in range(len(t.b))] for t in p.trunks]
    dlatent = torch.empty((p.c_pad, m), dtype=torch.float32, device=dev)
    check_band(st, p.table.shape[2])
    if tile_fit is not None and (tile_fit.dtype != torch.int32 or tile_fit.device != dev
                                 or tile_fit.shape != (-(-m // TILE),) or st.band is None):
        raise ValueError("tile_fit is a banded backward's int32 tensor of one entry a tile")
    desc = _descriptor(p, st, y, acts, lat, dy=dy, demb=demb, dtable=dtable, dmean=dmean,
                       dxp=dxp, dyp=dyp, dpre=dpre, grads=grads, dx_last=dx_last,
                       dlatent=dlatent, dpre16=dpre16, tile_fit=tile_fit)
    _run("pixel_train_bwd", _lib().pixel_train_bwd, dev, desc.ctypes.data, int(desc.size),
         float(np.float32(1.0 / st.keep)), int(bf16))
    counter = ("band_" if st.band is not None else "") + ("bf16_launches" if bf16 else "launches")
    setattr(pixel_train_decode_backward, counter,
            getattr(pixel_train_decode_backward, counter) + 1)
    return dtable, dmean, dxp, dyp, demb, grads


def flatten_pixel_params(trunks: Sequence[Trunk]) -> List[torch.Tensor]:
    """Per trunk: the ws, lats and xs that exist, then the bs."""
    out: List[torch.Tensor] = []
    for ws, lats, xs, bs in trunks:
        out += [t for group in (ws, lats, xs) for t in group if t is not None] + list(bs)
    return out


def unflatten_pixel_params(st: PixelTrainStatics, params) -> List[Trunk]:
    it = iter(params)
    n_layers = len(st.has_w)
    trunks = []
    for _ in st.layer_offsets:
        ws = [next(it) if has else None for has in st.has_w]
        lats = [next(it) if has else None for has in st.has_x]
        xs = [next(it) if has else None for has in st.has_x]
        trunks.append((ws, lats, xs, [next(it) for _ in range(n_layers)]))
    return trunks


class PixelTrainDecodeFunction(torch.autograd.Function):
    """K4 over both trunks: (y, x_last).  Inputs are unpadded, as
    ``pixel_train_decode_reference`` takes them, the trunks flattened by
    ``flatten_pixel_params``; the padding happens here and the padded rows
    and columns of every gradient are dropped on the way out.  The gated
    activations and the latent are the residuals; x_last is a view of the
    first trunk's last one, sliced of its padding (in bf16 a float32 copy,
    so that its gradient stays float32).  The backward takes dx_last = None
    when x_last fed nothing (no classifier)."""

    @staticmethod
    def forward(ctx, st: PixelTrainStatics, seed: int, table, mean, xp, yp, mask, emb, *params):
        trunks = unflatten_pixel_params(st, params)
        detached = [tuple([None if t is None else t.detach() for t in group] for group in tr)
                    for tr in trunks]
        packed = pack_pixel_trunks(table, mean, xp, yp, mask, emb, detached, st)
        y, acts, lat = pixel_train_decode_forward(packed, seed, st)
        ctx.st, ctx.packed, ctx.acts, ctx.lat, ctx.y = st, packed, acts, lat, y
        ctx.shapes = [[[None if t is None else t.shape for t in group] for group in tr]
                      for tr in trunks]
        ctx.c = table.shape[2]
        ctx.set_materialize_grads(False)
        return y, acts[0][-1][:trunks[0][3][-2].shape[-1]].T.to(torch.float32)

    @staticmethod
    def backward(ctx, dy: Optional[torch.Tensor], dx_last: Optional[torch.Tensor]):
        if dy is None:
            dy = torch.zeros_like(ctx.y)
        dtable, dmean, dxp, dyp, demb, grads = pixel_train_decode_backward(
            ctx.packed, ctx.st, ctx.y, ctx.acts, ctx.lat, dy, dx_last)
        flat: List[torch.Tensor] = []
        for (w_s, lat_s, x_s, b_s), g in zip(ctx.shapes, grads):
            flat += [dw[:s[0], :s[1]] for (dw, _, _, _), s in zip(g, w_s) if s is not None]
            flat += [dl[:ctx.c, :s[1]] for (_, dl, _, _), s in zip(g, lat_s) if s is not None]
            flat += [dx[:, :s[1]] for (_, _, dx, _), s in zip(g, x_s) if s is not None]
            flat += [db[:s[-1]] for (_, _, _, db), s in zip(g, b_s)]
        return (None, None, dtable, dmean, dxp, dyp, None, demb, *flat)


class PixelTrainDecodeReference(torch.autograd.Function):
    """K4's plain version as one autograd Function: the plain forward, and
    for the backward the plain backward on its residuals.  The CPU route of
    a bf16 decoder, where autograd through the plain forward would round the
    gradients at the forward's roundings instead of the contract's."""

    @staticmethod
    def forward(ctx, st: PixelTrainStatics, seed: int, table, mean, xp, yp, mask, emb, *params):
        trunks = unflatten_pixel_params(st, params)
        acts: List[List[torch.Tensor]] = []
        latent: List[torch.Tensor] = []
        y, x_last = pixel_train_decode_reference(table, mean, xp, yp, mask, emb, trunks, seed, st,
                                                 acts=acts, latent=latent)
        ctx.st, ctx.acts, ctx.lat, ctx.y = st, acts, latent[0], y
        ctx.operands = (table, mean, xp, yp, mask, emb, trunks)
        ctx.set_materialize_grads(False)
        return y, x_last

    @staticmethod
    def backward(ctx, dy: Optional[torch.Tensor], dx_last: Optional[torch.Tensor]):
        if dy is None:
            dy = torch.zeros_like(ctx.y)
        table, mean, xp, yp, mask, emb, trunks = ctx.operands
        dtable, dmean, dxp, dyp, demb, grads = pixel_train_decode_backward_reference(
            table, mean, xp, yp, mask, emb, trunks, ctx.st, ctx.y, ctx.acts, ctx.lat, dy,
            dx_last)
        return (None, None, dtable, dmean, dxp, dyp, None, demb, *flatten_pixel_params(grads))


def pixel_train_decode(table: torch.Tensor, mean: torch.Tensor, xp: torch.Tensor,
                       yp: torch.Tensor, mask: torch.Tensor, emb: torch.Tensor,
                       trunks: Sequence[Trunk], seed: int, st: PixelTrainStatics
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4: the (rows, M) tanh'd outputs of the trunks and x_last (M, h),
    both differentiable in the table, the mean, xp, yp, the embedding and
    every weight and bias, in ``st.dtype``'s contract.  ``st.band`` is
    checked on either device (``check_band``); it changes nothing on the
    CPU."""
    check_band(st, table.shape[2])
    if emb.device.type == "cpu":
        if st.dtype == torch.float32:
            return pixel_train_decode_reference(table, mean, xp, yp, mask, emb, trunks, seed, st)
        return PixelTrainDecodeReference.apply(st, seed, table, mean, xp, yp, mask, emb,
                                               *flatten_pixel_params(trunks))
    if emb.device.type != "cuda":
        raise ValueError(f"pixel_train_decode runs on cuda or cpu, not {emb.device}")
    return PixelTrainDecodeFunction.apply(st, seed, table, mean, xp, yp, mask, emb,
                                          *flatten_pixel_params(trunks))


pixel_train_decode.launches = 0
pixel_train_decode_backward.launches = 0
pixel_train_decode.bf16_launches = 0
pixel_train_decode_backward.bf16_launches = 0
pixel_train_decode_backward.band_launches = 0
pixel_train_decode_backward.band_bf16_launches = 0
