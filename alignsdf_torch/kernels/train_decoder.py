"""Kernel K2: one scene-factored decoder trunk for training, forward and
backward, with its plain PyTorch version and the wrappers that launch the
CUDA kernels (``csrc/train_decoder.cu``).

Replaces ``alignsdf_tpu/ops/decoder_train_kernel.py:fused_branch_scene``
(forward ``_fused_scene_fwd`` / ``_fwd_kernel_scene``, backward
``_fused_scene_bwd`` / ``_bwd_kernel_scene``).  The latent has already been
folded into per-scene bias tables outside (``ops/train_plan.py``), so the
trunk reads only the point embedding.  Layer ``l`` computes

    acc = a_{l-1} @ W_l (if W_l) + emb @ X_l (if X_l) + b_l[scene(row)] or b_l

then ReLU and the hash dropout gate on hidden layers, tanh on the last.
Point ``row`` belongs to scene ``row // n_per_scene``.  The last layer too
may read the embedding and a scene table, where ``latent_in`` names it (JAX's
factored kernel re-injects at any layer, :443-451): on the card its 1-2
rows stay on the CUDA cores, the forward adding emb @ X_last and the scene's
bias row, the chain d(emb) += dpre_last X_last^T before any hidden layer's
term, the reductions dX_last and the per-scene bias sums.  The forward also
gives ``x_last``, the last hidden layer's gated activation (the final
layer's input, which the classifier head reads), and the backward takes its
gradient ``dx_last``, added to the final layer's input gradient before the
last hidden layer's gate (JAX ``_bwd_kernel_scene`` :637-638).

With ``TrainStatics.dtype`` bfloat16 the trunk keeps the JAX kernel's bf16
contract (``_fused_scene_fwd`` / ``_fused_scene_bwd`` with ``cdtype``
bfloat16): the weights, inject weights and embedding rounded to bf16 once,
products of bf16 values summed in float32, each hidden activation rounded to
bf16 after ReLU and the gate (the residual, and the next layer's input),
the biases float32; in the backward every product takes the pre-activation
gradient rounded to bf16 (dx, dW, dX, d(emb)), the bias gradients sum it
unrounded, and the gate is (a_bf16 > 0) s.  The gradients returned are
float32 and unrounded, of the float32 operands.

``train_decode`` takes the plain version for a CPU tensor: in float32
autograd through it gives the gradients; in bf16 ``TrainDecodeReference``
pairs it with the plain backward, whose roundings autograd cannot give.
For a CUDA tensor it runs ``TrainDecodeFunction``, whose forward and
backward launch the kernels or raise.  Both run on the tensor cores
(``csrc/train_fwd_tc.cuh``, ``csrc/chain_tc.cuh``, ``csrc/wgrad_tc.cuh``),
split TF32 in float32 and bf16 ``wgmma`` in bf16, where the forward and the
backward's chain are their own designs (``csrc/train_fwd_bf16_tc.cuh``,
planned by ``train_fwd_bf16_plan``; ``csrc/chain_bf16_tc.cuh``, planned by
``chain_bf16_plan``): ``pack_trunk`` splits (or
rounds) the hidden weights once a call and tiles them as the forward reads
them and, transposed, as the backward's chain reads them (``layer_tiles``).
``train_decode.launches`` counts float32 forward launches and
``train_decode_backward.launches`` backward launches: one each per trunk per
train step; ``.bf16_launches`` counts the bf16 kernels' apart.
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from alignsdf_torch.kernels.grid_decoder import (
    TC_GROUP, TC_MAX_OUT, check_dtype, round_to, tf32_split, tile_halves, tile_weights)

PAD = 256         # hidden widths pad to a multiple of the tensor-core trunk's group
EMB_MAX = 64      # embedding columns a trunk may read
MAX_LAYERS = 10
MAX_OUT = 2       # outputs of the last layer
MAX_SMEM = 232448
_M32 = 0xFFFFFFFF
# the bf16 chain (csrc/chain_bf16_tc.cuh): points a block, blocks a cluster,
# ring stages of one k step's tiles (up to four 4 KB tiles), the io buffer's
# row, and its shared memory: the A buffer, the ring, the io buffer, the
# quarters' bias sums, the final rows' dpre and weights, 10 barriers, the
# block's scene segments and the alignment
CB_P, CB_CLUSTER, CB_RING, CB_STAGE, CB_IO_LD = 64, 2, 4, 4 * 4096, 144
CB_SMEM = (512 * CB_P * 2 + CB_RING * CB_STAGE + TC_MAX_OUT * CB_IO_LD + 2 * 4 * TC_MAX_OUT * 4
           + 2 * CB_P * 4 + TC_MAX_OUT * 2 * 4 + 8 * (2 * CB_RING + 2) + 2 * 40 + 1024)
# the bf16 forward (csrc/train_fwd_bf16_tc.cuh): points a block, blocks a
# cluster, each consumer warpgroup's ring of 4 KB tiles, and its shared
# memory: two A buffers of 512 rows x 64 points, the two rings, the
# embedding's rows, the final rows' group sums, 56 barriers and the
# alignment
FB_P, FB_CLUSTER, FB_SLOTS, FB_TILE = 64, 2, 10, 4096
FB_SMEM = (2 * 512 * FB_P * 2 + 2 * FB_SLOTS * FB_TILE + EMB_MAX * FB_P * 2 + 4 * 2 * FB_P * 4
           + 8 * (4 * FB_SLOTS + 16) + 1024)


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


class TrainStatics(NamedTuple):
    """The static structure of one trunk, per layer."""

    n_per_scene: int              # row // n_per_scene is a point's scene
    has_w: Tuple[bool, ...]       # reads the previous layer's activation
    has_x: Tuple[bool, ...]       # reads the embedding columns
    scene_bias: Tuple[bool, ...]  # bias is a per-scene (B, h) table
    dropout: Tuple[bool, ...]     # hidden layers with dropout
    keep: float
    train: bool
    dtype: torch.dtype = torch.float32  # the compute dtype: float32 or bfloat16


def gate_threshold(keep: float) -> int:
    """uint32 threshold of the gate: a unit is kept where hash < threshold."""
    return min(int(round(keep * 2 ** 32)), 2 ** 32 - 1)


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h * c) mod 2^32 for int64 h in [0, 2^32): the full product can pass
    2^63, so the high 16 bits of c go in separately."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def dropout_gate(seed: int, layer: int, rows: torch.Tensor, width: int,
                 keep: float) -> torch.Tensor:
    """(len(rows), width) float32 Bernoulli(keep) gate scaled by 1/keep:
    the murmur3-style finalizer of (seed, layer, global row, lane) with
    uint32 wraparound, bit for bit the TPU kernel's ``_dropout_gate``.
    ``rows`` are the points' rows in the trunk's M, lanes the true columns.
    CPU torch has no full uint32 arithmetic: int64, masked after each step."""
    grow = rows.to(torch.int64)[:, None]
    col = torch.arange(width, dtype=torch.int64, device=rows.device)[None, :]
    h = ((seed & _M32) ^ ((grow * 0x9E3779B1) & _M32) ^ ((col * 0x85EBCA6B) & _M32)
         ^ ((layer * 0xC2B2AE35) & _M32))
    h = h ^ (h >> 16)
    h = _mul32(h, 0x7FEB352D)
    h = h ^ (h >> 15)
    h = _mul32(h, 0x846CA68B)
    h = h ^ (h >> 16)
    return (h < gate_threshold(keep)).to(torch.float32) * np.float32(1.0 / keep)


def x_term(emb: torch.Tensor, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """emb @ X in ``dtype``'s contract.  X is (e, out), or (k e, out): k
    weights on the same e columns stacked, each rounded apart and its
    product summed in float32 (K5's layer 0 with 0 in latent_in in bf16,
    JAX's two products ``x0 @ W_0 + x0 @ W_in``)."""
    parts = x.split(emb.shape[1])
    term = emb @ round_to(parts[0], dtype)
    for part in parts[1:]:
        term = term + emb @ round_to(part, dtype)
    return term


def train_decode_reference(emb: torch.Tensor, ws: Sequence[Optional[torch.Tensor]],
                           xs: Sequence[Optional[torch.Tensor]], bs: Sequence[torch.Tensor],
                           seed: int, st: TrainStatics,
                           acts: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
    """The plain version of K2's forward, step by step with torch.matmul;
    in float32 autograd through it is the plain backward.  emb (M, e); ws[l]
    (in, out) or None; xs[l] (e, out) (or stacked, ``x_term``) or None; bs[l]
    (B, out) or (out,).
    Returns the tanh'd outputs as (n_out, M) and x_last, the last hidden
    layer's gated activation (M, h); ``acts``, if given, receives each
    hidden layer's gated activation (M, out).  In bf16 (``st.dtype``) the
    operands but the biases and each gated activation are rounded to bf16,
    the arithmetic float32 (or the inputs' float64)."""
    m = emb.shape[0]
    rows = torch.arange(m, device=emb.device)
    scene = rows // st.n_per_scene
    n_layers = len(bs)
    emb = round_to(emb, st.dtype)
    x = None
    for layer in range(n_layers):
        acc = None
        if ws[layer] is not None:
            acc = x @ round_to(ws[layer], st.dtype)
        if xs[layer] is not None:
            term = x_term(emb, xs[layer], st.dtype)
            acc = term if acc is None else acc + term
        acc = acc + (bs[layer][scene] if st.scene_bias[layer] else bs[layer])
        if layer == n_layers - 1:
            return torch.tanh(acc).T, x
        x = torch.relu(acc)
        if st.train and st.dropout[layer]:
            x = x * dropout_gate(seed, layer, rows, x.shape[1], st.keep).to(x.dtype)
        x = round_to(x, st.dtype)
        if acts is not None:
            acts.append(x)
    raise ValueError("a trunk needs at least one layer")


def train_decode_backward_reference(emb, ws, xs, bs, st: TrainStatics, y: torch.Tensor,
                                    acts: Sequence[torch.Tensor], dy: torch.Tensor,
                                    dx_last: Optional[torch.Tensor] = None,
                                    dpres: Optional[List[torch.Tensor]] = None):
    """The plain version of K2's backward, from the same inputs as the
    kernel: dy and y (n_out, M), the gated activations acts[l] (M, out) and
    x_last's gradient dx_last (M, h) or None.
    The gate is recovered as (a > 0) * s, s = 1/keep on dropout layers in
    training, else 1 (no hash replay).  Returns (d(emb), [dW | None],
    [dX | None], [db]) with db per scene (B, out) for scene-bias layers.  In
    bf16 every product takes dpre rounded to bf16 and the rounded operands
    (``acts`` hold bf16 values), the bias gradients dpre itself.  ``dpres``,
    if given, receives each layer's dpre (M, out), unrounded, from the final
    layer's down."""
    m = emb.shape[0]
    scene = torch.arange(m, device=emb.device) // st.n_per_scene
    n_layers = len(bs)
    dws, dxs, dbs = [None] * n_layers, [None] * n_layers, [None] * n_layers
    demb = torch.zeros_like(emb)
    emb_c = round_to(emb, st.dtype)
    dpre = (dy * (1.0 - y * y)).T  # (M, n_out)
    for layer in range(n_layers - 1, -1, -1):
        if dpres is not None:
            dpres.append(dpre)
        dr = round_to(dpre, st.dtype)
        if ws[layer] is not None:
            dws[layer] = acts[layer - 1].T @ dr
        if xs[layer] is not None:
            parts = xs[layer].split(emb.shape[1])
            dxs[layer] = (emb_c.T @ dr).repeat(len(parts), 1)
            for part in parts:
                demb = demb + dr @ round_to(part, st.dtype).T
        dbs[layer] = (torch.zeros_like(bs[layer]).index_add_(0, scene, dpre)
                      if st.scene_bias[layer] else dpre.sum(0))
        if layer > 0:
            scale = 1.0 / st.keep if st.train and st.dropout[layer - 1] else 1.0
            dx = dr @ round_to(ws[layer], st.dtype).T
            if layer == n_layers - 1 and dx_last is not None:
                dx = dx + dx_last
            dpre = dx * (acts[layer - 1] > 0).to(dpre.dtype) * np.float32(scale)
    return demb, dws, dxs, dbs


# ---------------------------------------------------------------------------
# the CUDA path
# ---------------------------------------------------------------------------

class _Packed(NamedTuple):
    """Padded, contiguous copies of one trunk in the kernels' layout (in
    bf16 the weights and the embedding hold their bf16-rounded values)."""

    emb_t: torch.Tensor                 # (e, M)
    w: List[Optional[torch.Tensor]]     # hidden (in_pad, out_pad); last (in_pad, n_out)
    wt: List[Optional[torch.Tensor]]    # the last layer's transpose of w (the forward's)
    x: List[Optional[torch.Tensor]]     # (e, out_pad)
    b: List[torch.Tensor]               # (B, out_pad) or (out_pad,)
    out_pads: List[int]
    n_scenes: int
    chain: torch.Tensor                 # the backward chain's weight tiles, last layer first
    fwd: torch.Tensor                   # the forward's weight tiles, in layer order
    dtype: torch.dtype = torch.float32  # the kernels' arithmetic
    emb16: Optional[torch.Tensor] = None  # bf16: emb_t as bf16, the reduction's dX operand
    fwd_x: Optional[torch.Tensor] = None  # bf16: the forward's X tiles, in layer order


def chain_bf16_plan(out_pads: Sequence[int], e: int, m: int, n_per_scene: int,
                    scene_bias: Sequence[bool], has_x: Sequence[bool], xl_w: int = 0) -> dict:
    """The bf16 backward chain's launch plan (``csrc/chain_bf16_tc.cuh``) for
    one trunk of padded widths ``out_pads`` (the hidden layers', then n_out)
    over m points, ``e`` embedding columns, ``n_per_scene`` points a scene,
    per layer a scene bias or not and X or not, dx_last ``xl_w`` columns
    wide (0: none).  Raises ValueError where the kernel cannot take it.

    Returns ``smem_bytes`` a block, ``points_per_block``, ``cluster``,
    ``blocks`` with points and the ``grid`` (rounded up to a cluster),
    ``ring_stages``, ``bulk`` (rows move by bulk copy: M % 8 == 0, the
    operands aligned), the db kernel's blocks ``db_items``, the partials'
    ``db_partial_floats``, the chain's ``tile_bytes`` and the
    ``l2_tile_bytes`` the clusters read from L2, and ``device_bytes``: what
    the call must move (the residuals read, dpre16 written, y and dy read,
    the weights read once, d(emb) and db written once, dx_last read),
    the bytes of its bound."""
    out_pads = [int(w) for w in out_pads]
    n_layers, n_out = len(out_pads), out_pads[-1] if out_pads else 0
    if not 2 <= n_layers <= MAX_LAYERS or not 1 <= n_out <= MAX_OUT:
        raise ValueError(f"the bf16 chain takes 2-{MAX_LAYERS} layers and 1-{MAX_OUT} outputs, "
                         f"got widths {out_pads}")
    if any(w < TC_GROUP or w % TC_GROUP or w > TC_MAX_OUT for w in out_pads[:-1]):
        raise ValueError(f"the bf16 chain takes hidden widths that are multiples of {TC_GROUP} "
                         f"up to {TC_MAX_OUT}, got {out_pads[:-1]}")
    if len(scene_bias) != n_layers or len(has_x) != n_layers:
        raise ValueError("one scene_bias and one has_x a layer")
    if not 1 <= e <= EMB_MAX:
        raise ValueError(f"the bf16 chain takes 1-{EMB_MAX} embedding columns, got {e}")
    if m <= 0 or m % 4 or n_per_scene <= 0 or m % n_per_scene:
        raise ValueError(f"M = {m} must be a positive multiple of 4 and of n_per_scene")
    if not 0 <= xl_w <= out_pads[-2]:
        raise ValueError(f"dx_last of {xl_w} columns does not fit a {out_pads[-2]}-wide input")
    if CB_SMEM > MAX_SMEM:
        raise ValueError(f"{CB_SMEM} bytes of shared memory exceed {MAX_SMEM}")
    blocks = -(-m // CB_P)
    grid = -(-blocks // CB_CLUSTER) * CB_CLUSTER
    segments = [m // n_per_scene if sb else 1 for sb in scene_bias]
    tile_bytes = 2 * sum(out_pads[i] * out_pads[i - 1] for i in range(1, n_layers - 1))
    weights = (tile_bytes + 4 * e * sum(w for w, x in zip(out_pads, has_x) if x)
               + 4 * out_pads[-2] * n_out)
    device_bytes = (2 * m * sum(out_pads[:-1]) + 2 * m * sum(out_pads) + 8 * n_out * m + weights
                    + 4 * m * e + 4 * sum(s * w for s, w in zip(segments, out_pads))
                    + 4 * m * xl_w)
    return {"smem_bytes": CB_SMEM, "points_per_block": CB_P, "cluster": CB_CLUSTER,
            "blocks": blocks, "grid": grid, "ring_stages": CB_RING, "bulk": int(m % 8 == 0),
            "db_items": sum(s * -(-w // 32) for s, w in zip(segments, out_pads)),
            "db_partial_floats": blocks * 2 * sum(out_pads), "tile_bytes": tile_bytes,
            "l2_tile_bytes": tile_bytes * grid // CB_CLUSTER, "device_bytes": device_bytes}


def train_fwd_bf16_plan(out_pads: Sequence[int], e: int, m: int, n_per_scene: int,
                        scene_bias: Sequence[bool], has_x: Sequence[bool]) -> dict:
    """The bf16 forward's launch plan (``csrc/train_fwd_bf16_tc.cuh``) for
    one trunk of padded widths ``out_pads`` (the hidden layers', then n_out)
    over m points, ``e`` embedding columns, ``n_per_scene`` points a scene,
    per layer a scene bias or not and X or not (layer 0 reads X alone).
    Raises ValueError where the kernel cannot take it.

    Returns ``smem_bytes`` a block, ``points_per_block``, ``cluster``,
    ``blocks`` with points and the ``grid`` (rounded up to a cluster),
    ``ring_stages`` (each consumer warpgroup's ring of 4 KB tiles),
    ``bulk`` (the residuals leave by TMA: M % 8 == 0), the forward's
    ``tile_bytes`` (W's and X's bf16 tiles) and the ``l2_tile_bytes`` the
    clusters read from L2 (each tile once per cluster of 128 points), and
    ``device_bytes``: what the call must move (the residuals and y written
    once, the embedding and the weights read once: the tiles, the biases,
    the final layer's), the bytes of its bound."""
    out_pads = [int(w) for w in out_pads]
    n_layers, n_out = len(out_pads), out_pads[-1] if out_pads else 0
    if not 2 <= n_layers <= MAX_LAYERS or not 1 <= n_out <= MAX_OUT:
        raise ValueError(f"the bf16 forward takes 2-{MAX_LAYERS} layers and 1-{MAX_OUT} "
                         f"outputs, got widths {out_pads}")
    hidden = out_pads[:-1]
    if any(w < TC_GROUP or w % TC_GROUP or w > TC_MAX_OUT for w in hidden):
        raise ValueError(f"the bf16 forward takes hidden widths that are multiples of {TC_GROUP} "
                         f"up to {TC_MAX_OUT}, got {hidden}")
    if len(scene_bias) != n_layers or len(has_x) != n_layers or not has_x[0]:
        raise ValueError("one scene_bias and one has_x a layer; layer 0 reads the embedding")
    if not 1 <= e <= EMB_MAX:
        raise ValueError(f"the bf16 forward takes 1-{EMB_MAX} embedding columns, got {e}")
    if m <= 0 or m % 4 or n_per_scene <= 0 or m % n_per_scene:
        raise ValueError(f"M = {m} must be a positive multiple of 4 and of n_per_scene")
    if FB_SMEM > MAX_SMEM:
        raise ValueError(f"{FB_SMEM} bytes of shared memory exceed {MAX_SMEM}")
    blocks = -(-m // FB_P)
    grid = -(-blocks // FB_CLUSTER) * FB_CLUSTER
    # W's tiles of the hidden layers after the first, X's (e rounded up to 16
    # rows) of every hidden layer that reads the embedding
    tile_bytes = 2 * (sum(a * b for a, b in zip(hidden, hidden[1:]))
                      + _round_up(e, 16) * sum(w for w, x in zip(hidden, has_x) if x))
    rows = [m // n_per_scene if sb else 1 for sb in scene_bias]
    weights = (tile_bytes + 4 * sum(r * w for r, w in zip(rows, out_pads))
               + 4 * hidden[-1] * n_out + (4 * e * n_out if has_x[-1] else 0))
    device_bytes = 2 * m * sum(hidden) + 4 * n_out * m + 4 * e * m + weights
    return {"smem_bytes": FB_SMEM, "points_per_block": FB_P, "cluster": FB_CLUSTER,
            "blocks": blocks, "grid": grid, "ring_stages": FB_SLOTS, "bulk": int(m % 8 == 0),
            "tile_bytes": tile_bytes, "l2_tile_bytes": tile_bytes * grid // FB_CLUSTER,
            "device_bytes": device_bytes}


def _pad2(t: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    out = torch.zeros((rows, cols), dtype=torch.float32, device=t.device)
    out[:t.shape[0], :t.shape[1]] = t
    return out


def _check(emb, ws, xs, bs, st: TrainStatics) -> Tuple[int, int]:
    """Raise on what the kernels do not take; returns (n_out, n_scenes)."""
    n_layers = len(bs)
    m, e = emb.shape
    check_dtype(st.dtype)
    if not 2 <= n_layers <= MAX_LAYERS:
        raise ValueError(f"the kernel takes 2-{MAX_LAYERS} layers, got {n_layers}")
    if ws[0] is not None or xs[0] is None or any(w is None for w in ws[1:]):
        raise ValueError("layer 0 reads only the embedding; later layers their input")
    n_out = bs[-1].shape[-1]
    if not 1 <= n_out <= MAX_OUT or not 1 <= e <= EMB_MAX:
        raise ValueError(f"{n_out} outputs / {e} embedding columns are outside the kernel")
    if m <= 0 or m % 4 or m >= 2 ** 31 or m % st.n_per_scene:
        raise ValueError(f"M = {m} must be a positive multiple of 4 and of n_per_scene")
    for t in [emb, *ws, *xs, *bs]:
        if t is not None and (t.dtype != torch.float32 or t.device != emb.device):
            raise ValueError("every operand must be float32 on the embedding's device")
    n_scenes = m // st.n_per_scene
    for layer, b in enumerate(bs):
        if st.scene_bias[layer] and b.shape[0] != n_scenes:
            raise ValueError(f"layer {layer}: {b.shape[0]} bias rows for {n_scenes} scenes")
    return n_out, n_scenes


def layer_tiles(*weights: Optional[torch.Tensor], dtype: torch.dtype = torch.float32
                ) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
    """One hidden layer's weight tiles for the tensor-core forward and
    backward chain, from one split: the padded weights that read the
    layer's input rows, each (rows, out_pad) -- W on its activation, then
    K4's Lat on the latent -- stacked as S (depth, out_pad) and split into
    TF32 halves once.  Returns (forward's, chain's): ``tile_halves`` of S,
    the B of acc = [a | lat] @ S with the latent's rows right above the
    activation's (``csrc/train_fwd_tc.cuh``), and of S^T, the B of dx =
    dpre @ S^T with the layer's out_pad as the depth, its dx rows, then its
    dlat rows (``csrc/chain_tc.cuh``).  In bf16 S is rounded instead and
    both are ``tile_weights``' bf16 tiles (128 outputs x 16 k).  None where
    the layer has none (K2's layer 0, which reads the embedding alone)."""
    parts = [w for w in weights if w is not None]
    if not parts:
        return None
    s = torch.cat(parts) if len(parts) > 1 else parts[0]
    if max(s.shape) > TC_MAX_OUT or s.shape[0] % TC_GROUP or s.shape[1] % TC_GROUP:
        raise ValueError(f"the tensor-core forward and chain take layers of at most "
                         f"{TC_MAX_OUT} input rows and outputs, multiples of {TC_GROUP}, got "
                         f"({s.shape[0]}, {s.shape[1]})")
    if check_dtype(dtype) == torch.bfloat16:
        return (tile_weights(s, s.shape[0], s.shape[1], dtype),
                tile_weights(s.T, s.shape[1], s.shape[0], dtype))
    halves = torch.stack(tf32_split(s))
    return tile_halves(halves), tile_halves(halves.transpose(1, 2))


def tile_stream(runs: Sequence[torch.Tensor], device: torch.device) -> torch.Tensor:
    """Tile runs as one stream, in the order a kernel reads them."""
    return torch.cat(list(runs)) if runs else torch.zeros(0, dtype=torch.float32, device=device)


def pack_trunk(emb, ws, xs, bs, st: TrainStatics) -> _Packed:
    """Padded, contiguous copies of one trunk's operands (detached) for the
    kernels, the forward's tiles and the backward chain's, in ``st.dtype``
    (bf16: the weights and the embedding rounded, the biases not); raises
    on what they do not take."""
    n_out, n_scenes = _check(emb, ws, xs, bs, st)
    n_layers = len(bs)
    w, x, b, out_pads = [], [], [], []
    in_pad = 0
    for layer in range(n_layers):
        out = bs[layer].shape[-1]
        out_pad = n_out if layer == n_layers - 1 else _round_up(out, PAD)
        w.append(None if ws[layer] is None
                 else _pad2(round_to(ws[layer], st.dtype), in_pad, out_pad))
        x.append(None if xs[layer] is None
                 else _pad2(round_to(xs[layer], st.dtype), emb.shape[1], out_pad))
        bl = bs[layer]
        b.append(_pad2(bl, bl.shape[0], out_pad) if bl.dim() == 2
                 else _pad2(bl[None], 1, out_pad)[0])
        out_pads.append(out_pad)
        in_pad = out_pad
    if max(out_pads[:-1]) > TC_MAX_OUT:
        raise ValueError(f"the tensor-core forward and chain take hidden widths up to "
                         f"{TC_MAX_OUT}")
    wt = [None] * (n_layers - 1) + [w[-1].T.contiguous()]
    tiles = [layer_tiles(w[layer], dtype=st.dtype) for layer in range(1, n_layers - 1)]
    fwd = tile_stream([t[0] for t in tiles], emb.device)
    chain = tile_stream([t[1] for t in reversed(tiles)], emb.device)
    emb_t = round_to(emb, st.dtype).T.contiguous()
    emb16 = fwd_x = None
    if st.dtype == torch.bfloat16:
        emb16 = emb_t.to(torch.bfloat16)
        # the bf16 forward's X terms run on the tensor cores, k steps after W's
        e16 = _round_up(emb.shape[1], 16)
        fwd_x = tile_stream([tile_weights(x[layer], e16, out_pads[layer], st.dtype)
                             for layer in range(n_layers - 1) if x[layer] is not None],
                            emb.device)
    return _Packed(emb_t, w, wt, x, b, out_pads, n_scenes, chain, fwd, st.dtype, emb16, fwd_x)


def _ptr(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.data_ptr()


def _descriptor(p: _Packed, st: TrainStatics, y, acts, dy=None, demb=None, dpre=None,
                grads=None, dx_last=None, dpre16=None, db_part=None) -> np.ndarray:
    """The int64 descriptor ``train_decoder.cu`` parses (see its header)."""
    n_layers = len(p.b)
    e, m = p.emb_t.shape
    desc = [n_layers, p.out_pads[-1], e, m, st.n_per_scene, p.n_scenes,
            _ptr(p.emb_t), _ptr(y), _ptr(dy), _ptr(demb), _ptr(dx_last),
            0 if dx_last is None else dx_last.shape[1], _ptr(p.chain), p.chain.numel(),
            _ptr(p.fwd), p.fwd.numel(), _ptr(p.emb16), _ptr(db_part),
            0 if db_part is None else db_part.numel(), _ptr(p.fwd_x),
            0 if p.fwd_x is None else p.fwd_x.numel()]
    in_pad = 0
    for layer in range(n_layers):
        dw, dx, db = grads[layer] if grads is not None else (None, None, None)
        desc += [_ptr(p.w[layer]), _ptr(p.wt[layer]), _ptr(p.x[layer]), _ptr(p.b[layer]),
                 _ptr(acts[layer]) if layer < n_layers - 1 else 0,
                 _ptr(dpre[layer]) if dpre is not None else 0,
                 _ptr(dw), _ptr(dx), _ptr(db), in_pad, p.out_pads[layer],
                 int(st.scene_bias[layer]),
                 int(layer < n_layers - 1 and st.train and st.dropout[layer]),
                 _ptr(dpre16[layer]) if dpre16 is not None else 0]
        in_pad = p.out_pads[layer]
    return np.ascontiguousarray(desc, np.int64)


def _lib():
    from alignsdf_torch.kernels.build import load

    lib = load("train_decoder")
    if not getattr(lib, "_typed", False):
        lib.train_decoder_fwd.restype = ctypes.c_int
        lib.train_decoder_fwd.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_uint,
                                          ctypes.c_uint, ctypes.c_float, ctypes.c_int,
                                          ctypes.c_void_p]
        lib.train_decoder_bwd.restype = ctypes.c_int
        lib.train_decoder_bwd.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                                          ctypes.c_int, ctypes.c_void_p]
        lib.train_decoder_chain_bf16_plan.restype = ctypes.c_int
        lib.train_decoder_chain_bf16_plan.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                                      ctypes.c_void_p]
        lib.train_decoder_fwd_bf16_plan.restype = ctypes.c_int
        lib.train_decoder_fwd_bf16_plan.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                                    ctypes.c_void_p]
        lib._typed = True
    return lib


def _run(name: str, fn, device: torch.device, *args) -> None:
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed with code {rc}"
                           + (" (descriptor rejected)" if rc == -1 else ""))


def train_decode_forward(p: _Packed, seed: int, st: TrainStatics):
    """K2 forward on the card, on the tensor cores: y (n_out, M) float32 and
    the gated activations of the hidden layers, each (out_pad, M), bf16 on a
    bf16 pack.  A float32 pack runs ``train_fwd_tc_kernel`` (split TF32), a
    bf16 one ``train_fwd_bf16_kernel`` (``csrc/train_fwd_bf16_tc.cuh``;
    ``train_fwd_bf16_plan`` raises on what it does not take)."""
    e, m = p.emb_t.shape
    dev = p.emb_t.device
    bf16 = p.dtype == torch.bfloat16
    if bf16:  # raises on what the kernel does not take
        train_fwd_bf16_plan(p.out_pads, e, m, st.n_per_scene, st.scene_bias,
                            [x is not None for x in p.x])
    y = torch.empty((p.out_pads[-1], m), dtype=torch.float32, device=dev)
    acts = [torch.empty((h, m), dtype=p.dtype, device=dev) for h in p.out_pads[:-1]]
    desc = _descriptor(p, st, y, acts)
    _run("train_decoder_fwd", _lib().train_decoder_fwd, dev, desc.ctypes.data, int(desc.size),
         seed & _M32, gate_threshold(st.keep), float(np.float32(1.0 / st.keep)), int(bf16))
    if bf16:
        train_decode.bf16_launches += 1
    else:
        train_decode.launches += 1
    return y, acts


def _backward_descriptor(p: _Packed, st: TrainStatics, y: torch.Tensor,
                         acts: List[torch.Tensor], dy: torch.Tensor,
                         dx_last: Optional[torch.Tensor]):
    """A backward's outputs and scratch, allocated, and its descriptor:
    (desc, demb, grads, the scratch kept alive until the launch)."""
    e, m = p.emb_t.shape
    dev = p.emb_t.device
    dy = dy.to(torch.float32).contiguous()
    if dx_last is not None:
        dx_last = dx_last.to(torch.float32).contiguous()
        if dx_last.shape[0] != m or not 1 <= dx_last.shape[1] <= p.out_pads[-2]:
            raise ValueError(f"dx_last {tuple(dx_last.shape)} does not fit the trunk")
    demb = torch.empty((m, e), dtype=torch.float32, device=dev)
    dpre = dpre16 = db_part = None
    if p.dtype == torch.bfloat16:
        plan = chain_bf16_plan(p.out_pads, e, m, st.n_per_scene, st.scene_bias,
                               [x is not None for x in p.x],
                               0 if dx_last is None else dx_last.shape[1])
        dpre16 = [torch.empty((h, m), dtype=torch.bfloat16, device=dev) for h in p.out_pads]
        db_part = torch.empty(plan["db_partial_floats"], dtype=torch.float32, device=dev)
    else:
        dpre = [torch.empty((h, m), dtype=torch.float32, device=dev) for h in p.out_pads]
    grads = []
    for layer in range(len(p.b)):
        zeros = lambda t: None if t is None else torch.zeros_like(t)  # noqa: E731
        grads.append((zeros(p.w[layer]), zeros(p.x[layer]), torch.zeros_like(p.b[layer])))
    desc = _descriptor(p, st, y, acts, dy=dy, demb=demb, dpre=dpre, grads=grads,
                       dx_last=dx_last, dpre16=dpre16, db_part=db_part)
    return desc, demb, grads, (dy, dx_last, dpre, dpre16, db_part)


def train_decode_backward(p: _Packed, st: TrainStatics, y: torch.Tensor,
                          acts: List[torch.Tensor], dy: torch.Tensor,
                          dx_last: Optional[torch.Tensor] = None):
    """K2 backward on the card: the reverse chain per 64-point tile on the
    tensor cores (adding ``dx_last`` (M, h), if given, to the final layer's
    input gradient, then writing each layer's pre-activation gradient and
    d(emb)), then per layer the weight, inject-weight and bias reductions
    over all M points.  On a bf16 pack the chain (``csrc/chain_bf16_tc.cuh``)
    writes each pre-activation gradient once, rounded to bf16 for the
    products' reductions, and sums the bias gradients from the unrounded
    values in its registers into per-block partials (a scratch of
    ``chain_bf16_plan``'s ``db_partial_floats``), which a second kernel
    adds up in a fixed order: no float32 dpre is allocated.
    Returns (demb (M, e), [(dW | None, dX | None, db)] padded)."""
    bf16 = p.dtype == torch.bfloat16
    desc, demb, grads, _scratch = _backward_descriptor(p, st, y, acts, dy, dx_last)
    _run("train_decoder_bwd", _lib().train_decoder_bwd, p.emb_t.device, desc.ctypes.data,
         int(desc.size), float(np.float32(1.0 / st.keep)), int(bf16))
    if bf16:
        train_decode_backward.bf16_launches += 1
    else:
        train_decode_backward.launches += 1
    return demb, grads


CB_PLAN_KEYS = ("smem_bytes", "points_per_block", "cluster", "grid", "blocks", "ring_stages",
                "bulk", "db_items")


def chain_bf16_card_plan(p: _Packed, st: TrainStatics, y: torch.Tensor,
                         acts: List[torch.Tensor], dy: torch.Tensor,
                         dx_last: Optional[torch.Tensor] = None) -> dict:
    """The bf16 chain launcher's own plan (``CB_PLAN_KEYS``) for this
    backward on a bf16 pack on the card, read from the library without a
    launch: what ``chain_bf16_plan`` must agree with."""
    if p.dtype != torch.bfloat16 or p.emb_t.device.type != "cuda":
        raise ValueError("the bf16 chain's plan is read for a bf16 pack on the card")
    desc, _, _, _scratch = _backward_descriptor(p, st, y, acts, dy, dx_last)
    out = (ctypes.c_int * len(CB_PLAN_KEYS))()
    rc = _lib().train_decoder_chain_bf16_plan(desc.ctypes.data, int(desc.size),
                                              ctypes.addressof(out))
    if rc != 0:
        raise RuntimeError(f"train_decoder_chain_bf16_plan failed with code {rc}")
    return dict(zip(CB_PLAN_KEYS, out))


FB_PLAN_KEYS = ("smem_bytes", "points_per_block", "cluster", "grid", "blocks", "ring_stages",
                "bulk")


def fwd_bf16_card_plan(p: _Packed, st: TrainStatics) -> dict:
    """The bf16 forward launcher's own plan (``FB_PLAN_KEYS``) for a forward
    of this bf16 pack on the card, read from the library without a launch:
    what ``train_fwd_bf16_plan`` must agree with."""
    if p.dtype != torch.bfloat16 or p.emb_t.device.type != "cuda":
        raise ValueError("the bf16 forward's plan is read for a bf16 pack on the card")
    y = torch.empty((p.out_pads[-1], p.emb_t.shape[1]), dtype=torch.float32,
                    device=p.emb_t.device)
    acts = [torch.empty((h, p.emb_t.shape[1]), dtype=p.dtype, device=p.emb_t.device)
            for h in p.out_pads[:-1]]
    desc = _descriptor(p, st, y, acts)
    out = (ctypes.c_int * len(FB_PLAN_KEYS))()
    rc = _lib().train_decoder_fwd_bf16_plan(desc.ctypes.data, int(desc.size),
                                            ctypes.addressof(out))
    if rc != 0:
        raise RuntimeError(f"train_decoder_fwd_bf16_plan failed with code {rc}")
    return dict(zip(FB_PLAN_KEYS, out))


class TrainDecodeFunction(torch.autograd.Function):
    """K2 over one trunk: (y, x_last).  Inputs are unpadded, as
    ``train_decode_reference`` takes them, flattened as (emb, ws that exist,
    xs that exist, bs); the padding happens here and the padded rows and
    columns of every gradient are dropped on the way out.  The gated
    activations are the residuals; x_last is a view of the last one, sliced
    of its padding (in bf16 a float32 copy, so that its gradient stays
    float32).  The backward takes dx_last = None when x_last fed nothing
    (no classifier)."""

    @staticmethod
    def forward(ctx, st: TrainStatics, seed: int, emb: torch.Tensor, *params):
        ws, xs, bs = unflatten_params(st, params)
        packed = pack_trunk(emb.detach(), [None if w is None else w.detach() for w in ws],
                       [None if x is None else x.detach() for x in xs],
                       [b.detach() for b in bs], st)
        y, acts = train_decode_forward(packed, seed, st)
        ctx.st, ctx.packed, ctx.acts, ctx.y = st, packed, acts, y
        ctx.shapes = ([None if w is None else w.shape for w in ws],
                      [None if x is None else x.shape for x in xs], [b.shape for b in bs])
        ctx.set_materialize_grads(False)
        return y, acts[-1][:bs[-2].shape[-1]].T.to(torch.float32)

    @staticmethod
    def backward(ctx, dy: Optional[torch.Tensor], dx_last: Optional[torch.Tensor]):
        st = ctx.st
        if dy is None:
            dy = torch.zeros_like(ctx.y)
        demb, grads = train_decode_backward(ctx.packed, st, ctx.y, ctx.acts, dy, dx_last)
        w_shapes, x_shapes, b_shapes = ctx.shapes
        d_w = [dw[:s[0], :s[1]] for (dw, _, _), s in zip(grads, w_shapes) if s is not None]
        d_x = [dx[:, :s[1]] for (_, dx, _), s in zip(grads, x_shapes) if s is not None]
        d_b = [db[..., :s[-1]] for (_, _, db), s in zip(grads, b_shapes)]
        return (None, None, demb, *d_w, *d_x, *d_b)


class TrainDecodeReference(torch.autograd.Function):
    """K2's plain version as one autograd Function: the plain forward, and
    for the backward the plain backward on its residuals.  The CPU route of
    a bf16 trunk, where autograd through the plain forward would round the
    gradients at the forward's roundings instead of the contract's."""

    @staticmethod
    def forward(ctx, st: TrainStatics, seed: int, emb: torch.Tensor, *params):
        ws, xs, bs = unflatten_params(st, params)
        acts: List[torch.Tensor] = []
        y, x_last = train_decode_reference(emb, ws, xs, bs, seed, st, acts=acts)
        ctx.st, ctx.acts, ctx.y, ctx.operands = st, acts, y, (emb, ws, xs, bs)
        ctx.set_materialize_grads(False)
        return y, x_last

    @staticmethod
    def backward(ctx, dy: Optional[torch.Tensor], dx_last: Optional[torch.Tensor]):
        if dy is None:
            dy = torch.zeros_like(ctx.y)
        emb, ws, xs, bs = ctx.operands
        demb, dws, dxs, dbs = train_decode_backward_reference(emb, ws, xs, bs, ctx.st, ctx.y,
                                                              ctx.acts, dy, dx_last)
        return (None, None, demb, *flatten_params(dws, dxs, dbs))


def flatten_params(ws, xs, bs) -> List[torch.Tensor]:
    return [w for w in ws if w is not None] + [x for x in xs if x is not None] + list(bs)


def unflatten_params(st: TrainStatics, params):
    it = iter(params)
    ws = [next(it) if has else None for has in st.has_w]
    xs = [next(it) if has else None for has in st.has_x]
    return ws, xs, list(it)


def train_decode(emb: torch.Tensor, ws: Sequence[Optional[torch.Tensor]],
                 xs: Sequence[Optional[torch.Tensor]], bs: Sequence[torch.Tensor],
                 seed: int, st: TrainStatics) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2: the (n_out, M) tanh'd outputs of one trunk and x_last (M, h),
    both differentiable in emb and every weight and bias, in ``st.dtype``'s
    contract."""
    if emb.device.type == "cpu":
        if st.dtype == torch.float32:
            return train_decode_reference(emb, ws, xs, bs, seed, st)
        return TrainDecodeReference.apply(st, seed, emb, *flatten_params(ws, xs, bs))
    if emb.device.type != "cuda":
        raise ValueError(f"train_decode runs on cuda or cpu, not {emb.device}")
    return TrainDecodeFunction.apply(st, seed, emb, *flatten_params(ws, xs, bs))


train_decode.launches = 0
train_decode_backward.launches = 0
train_decode.bf16_launches = 0
train_decode_backward.bf16_launches = 0
