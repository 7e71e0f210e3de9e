"""Kernel K5: one generic decoder trunk for training on materialized input
rows, forward and backward, with its plain PyTorch version and the wrappers
that launch the CUDA kernels (``csrc/generic_train_decoder.cu``).

Replaces ``alignsdf_tpu/ops/decoder_train_kernel.py:fused_branch`` (forward
``_fused_branch_fwd`` / ``_fwd_kernel``, backward ``_fused_branch_bwd`` /
``_bwd_kernel``).  Each point's input row x0 (M, e) is its [latent,
embedding] row, so layer ``l`` computes

    acc = a_{l-1} @ W_l (if W_l) + x0 @ X_l (if X_l) + b_l

with X_0 layer 0's weight and X_l a latent_in layer's W_in, then ReLU and
K2's hash dropout gate on hidden layers (global row, true lane), tanh on the
last layer.  Where ``latent_in`` names the last layer (JAX's ``_fwd_kernel``
:117-121), its 1-2 rows read all of x0 on the CUDA cores: the forward adds
x0 @ X_last over the head's and the tail's columns alike, the chain stores
d(x0) = dpre_last X_last^T first, and the reductions give dX_last.  That
is K2's function with x0 in place of the embedding and no scene table, so
the plain versions are K2's
(``train_decode_reference``, ``train_decode_backward_reference``) on
statics whose ``scene_bias`` is all False.  The forward also gives
``x_last``, the last hidden layer's gated activation; the backward takes its
gradient ``dx_last`` and gives d(x0) over the whole row.

On the card both run K4's design, split TF32 on the tensor cores
(``csrc/train_fwd_tc.cuh``, ``csrc/chain_tc.cuh``, ``csrc/wgrad_tc.cuh``),
with x0's leading columns where K4's latent goes: ``pack_generic_trunk``
splits x0 at a head width h (``head_width``); a layer with X runs one
product over [activation; head] against the tiles of [W_l; X_l[:h]]
(``train_decoder.layer_tiles``, the chain's from the same split), and the
tail's columns, X_l[h:] in float32, enter on the CUDA cores as K2's
embedding does.  At the flagship with latent_in (0, 2) the head is the 256
latent columns and the tail the embedding's 6.  The bound is K4's: 0.787 M
multiply-adds a point a trunk each way, 2.44 ms a step in split TF32.

With ``TrainStatics.dtype`` bfloat16 the trunk keeps the JAX kernel's bf16
contract (``_fused_branch_fwd`` / ``_fused_branch_bwd`` with ``cdtype``
bfloat16, :152-159, ``_fwd_kernel`` :95-139, ``_bwd_kernel`` :207-285), K2's
with x0 for the embedding: x0, the weights and the input weights rounded to
bf16 once, the biases float32, the residuals bf16 and x_last float32 of
them; the backward takes dpre rounded into every product and sums d(x0) in
float32.  With 0 in latent_in, layer 0 reads x0 through two weights, which
JAX rounds apart and multiplies in two products: in bf16 the plan hands
them stacked, (2 e, out) (``train_decoder.x_term``), and the kernels run
one product over [head; head] against [W_0; W_in]'s tiles, the tail's
columns through the two weights' rounded sum; in float32 the plan sums
them, as before.  Every gradient leaves float32 and unrounded.

``generic_train_decode`` takes the plain version for a CPU tensor: in
float32 autograd through it gives the gradients; in bf16
``TrainDecodeReference`` (K2's) pairs it with the plain backward.  For a
CUDA tensor it runs ``GenericTrainDecodeFunction``, whose forward and
backward launch the kernels or raise.  ``generic_train_decode.launches``
counts float32 forward launches and ``generic_train_decode_backward.launches``
backward launches: one each per trunk per train step; ``.bf16_launches``
counts the bf16 kernels' apart.
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from alignsdf_torch.kernels.grid_decoder import TC_GROUP, TC_MAX_OUT, check_dtype, round_to
from alignsdf_torch.kernels.train_decoder import (
    _M32,
    PAD,
    TrainDecodeReference,
    TrainStatics,
    _pad2,
    _ptr,
    _round_up,
    _run,
    flatten_params,
    gate_threshold,
    layer_tiles,
    tile_stream,
    train_decode_backward_reference,
    train_decode_reference,
    unflatten_params,
)

MAX_LAYERS = 10
MAX_OUT = 2       # outputs of the last layer

# the plain versions: K2's, on statics without scene tables
generic_train_decode_reference = train_decode_reference
generic_train_decode_backward_reference = train_decode_backward_reference


class _Packed(NamedTuple):
    """Padded, contiguous copies of one trunk in the kernels' layout (in bf16
    x0 and the weights hold their bf16-rounded values)."""

    x0_t: torch.Tensor                  # (e, M)
    w: List[Optional[torch.Tensor]]     # hidden (in_pad, out_pad); last (in_pad, n_out)
    wt: List[Optional[torch.Tensor]]    # the last layer's transpose of w (the forward's)
    tail: List[Optional[torch.Tensor]]  # X's rows past the head (e - head, out_pad); all of
    #                                     X (e, n_out) at a latent_in final layer
    b: List[torch.Tensor]               # (out_pad,)
    out_pads: List[int]
    has_x: List[bool]                   # the layer reads x0
    head: int                           # x0's leading columns the products read
    head_pad: int                       # ... rounded up to a tensor-core group
    chain: torch.Tensor                 # the backward chain's weight tiles, last layer first
    fwd: torch.Tensor                   # the forward's weight tiles, in layer order
    twice: bool = False                 # layer 0 reads the head twice (stacked X_0)
    dtype: torch.dtype = torch.float32  # the kernels' arithmetic
    x016: Optional[torch.Tensor] = None  # bf16: x0_t as bf16, the reduction's dX operand


def _check(x0, ws, xs, bs, st: TrainStatics) -> int:
    """Raise on what the kernels do not take; returns n_out."""
    n_layers = len(bs)
    m, e = x0.shape
    check_dtype(st.dtype)
    if not 2 <= n_layers <= MAX_LAYERS:
        raise ValueError(f"the kernel takes 2-{MAX_LAYERS} layers, got {n_layers}")
    if ws[0] is not None or xs[0] is None or any(w is None for w in ws[1:]):
        raise ValueError("layer 0 reads only the input row; later layers their input")
    if xs[0].shape[0] not in (e, 2 * e) or any(x.shape[0] != e for x in xs[1:] if x is not None):
        raise ValueError("the input weights read the row's e columns (layer 0: once or twice)")
    if any(st.scene_bias) or any(b.dim() != 1 for b in bs):
        raise ValueError("the generic trunk has no scene tables")
    n_out = bs[-1].shape[-1]
    if not 1 <= n_out <= MAX_OUT:
        raise ValueError(f"{n_out} outputs are outside the kernel")
    if m <= 0 or m % 4 or m >= 2 ** 31:
        raise ValueError(f"M = {m} must be a positive multiple of 4")
    for t in [x0, *ws, *xs, *bs]:
        if t is not None and (t.dtype != torch.float32 or t.device != x0.device):
            raise ValueError("every operand must be float32 on the input's device")
    return n_out


def head_width(e: int, x_in_pads: Sequence[int], twice: bool = False) -> int:
    """How many of x0's e leading columns K5's products read (the head):
    all of them where, rounded up to a tensor-core group, they fit the
    buffer's TC_MAX_OUT rows beside the widest padded activation that a
    later layer with X reads (``x_in_pads``) and, where layer 0 reads the
    head ``twice``, beside its first copy, else the rows left there (a
    multiple of the group, perhaps 0).  The rest, the tail, goes on the
    CUDA cores.  The flagship with latent_in (0, 2): 512 - 256 = 256 of its
    262 columns (the latent), and 256 of 319 at --point_size 63."""
    room = TC_MAX_OUT - max(x_in_pads, default=0)
    if twice:
        room = min(room, TC_MAX_OUT // 2)
    return e if _round_up(e, TC_GROUP) <= room else room


def pack_generic_trunk(x0, ws, xs, bs, st: TrainStatics) -> _Packed:
    """Padded, contiguous copies of one trunk's operands (detached) for the
    kernels, in ``st.dtype`` (bf16: x0 and the weights rounded, the biases
    not, and x0's bf16 copy): x0 feature-major, the head's forward and chain
    tiles, the tail's rows of X (of a stacked X_0, the sum of its rounded
    weights; of a latent_in final layer, all of X); raises on what they do
    not take."""
    n_out = _check(x0, ws, xs, bs, st)
    dt = st.dtype
    n_layers = len(bs)
    e = x0.shape[1]
    w, b, out_pads, in_pads = [], [], [], []
    in_pad = 0
    for layer in range(n_layers):
        out_pad = n_out if layer == n_layers - 1 else _round_up(bs[layer].shape[-1], PAD)
        w.append(None if ws[layer] is None
                 else _pad2(round_to(ws[layer], dt), in_pad, out_pad))
        b.append(_pad2(bs[layer][None], 1, out_pad)[0])
        out_pads.append(out_pad)
        in_pads.append(in_pad)
        in_pad = out_pad
    if max(out_pads[:-1]) > TC_MAX_OUT:
        raise ValueError(f"the tensor-core forward and chain take hidden widths up to "
                         f"{TC_MAX_OUT}")
    has_x = [x is not None for x in xs]
    twice = xs[0].shape[0] == 2 * e
    h = head_width(e, [in_pads[layer] for layer in range(1, n_layers - 1) if has_x[layer]], twice)
    h_pad = _round_up(h, TC_GROUP)
    parts = [None if x is None else [round_to(p, dt) for p in x.split(e)] for x in xs]
    heads = [[] if p is None or h == 0 else [_pad2(q[:h], h_pad, out_pad) for q in p]
             for p, out_pad in zip(parts, out_pads)]
    tail = [None if p is None or h == e else _pad2(sum(q[h:] for q in p), e - h, out_pad)
            for p, out_pad in zip(parts[:-1], out_pads)]
    # a latent_in final layer reads all of x0 on the CUDA cores: its `tail`
    # is X's e rows
    tail.append(None if parts[-1] is None else _pad2(parts[-1][0], e, n_out))
    wt = [None] * (n_layers - 1) + [w[-1].T.contiguous()]
    tiles = [t for t in (layer_tiles(w[layer], *heads[layer], dtype=dt)
                         for layer in range(n_layers - 1)) if t is not None]
    fwd = tile_stream([t[0] for t in tiles], x0.device)
    chain = tile_stream([t[1] for t in reversed(tiles)], x0.device)
    x0_t = round_to(x0, dt).T.contiguous()
    return _Packed(x0_t, w, wt, tail, b, out_pads, has_x, h, h_pad, chain, fwd, twice, dt,
                   x0_t.to(torch.bfloat16) if dt == torch.bfloat16 else None)


def _descriptor(p: _Packed, st: TrainStatics, y, acts, dy=None, dx0=None, dpre=None,
                grads=None, dx_last=None, dpre16=None) -> np.ndarray:
    """The int64 descriptor ``generic_train_decoder.cu`` parses (see its
    host side)."""
    n_layers = len(p.b)
    e, m = p.x0_t.shape
    desc = [n_layers, p.out_pads[-1], e, p.head, p.head_pad, m, _ptr(p.x0_t), _ptr(y), _ptr(dy),
            _ptr(dx0), _ptr(dx_last), 0 if dx_last is None else dx_last.shape[1],
            _ptr(p.chain), p.chain.numel(), _ptr(p.fwd), p.fwd.numel(), int(p.twice),
            _ptr(p.x016)]
    in_pad = 0
    for layer in range(n_layers):
        hidden = layer < n_layers - 1
        dw, dx, db = grads[layer] if grads is not None else (None, None, None)
        desc += [_ptr(p.w[layer]), _ptr(p.wt[layer]), _ptr(p.tail[layer]), _ptr(p.b[layer]),
                 _ptr(acts[layer]) if hidden else 0,
                 _ptr(dpre[layer]) if dpre is not None else 0, _ptr(dw), _ptr(dx), _ptr(db),
                 in_pad, p.out_pads[layer], int(p.has_x[layer]),
                 int(hidden and st.train and st.dropout[layer]),
                 _ptr(dpre16[layer]) if dpre16 is not None else 0]
        in_pad = p.out_pads[layer]
    return np.ascontiguousarray(desc, np.int64)


def _lib():
    from alignsdf_torch.kernels.build import load

    lib = load("generic_train_decoder")
    if not getattr(lib, "_typed", False):
        lib.generic_train_decoder_fwd.restype = ctypes.c_int
        lib.generic_train_decoder_fwd.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_uint,
                                                  ctypes.c_uint, ctypes.c_float, ctypes.c_int,
                                                  ctypes.c_void_p]
        lib.generic_train_decoder_bwd.restype = ctypes.c_int
        lib.generic_train_decoder_bwd.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                                                  ctypes.c_int, ctypes.c_void_p]
        lib._typed = True
    return lib


def generic_train_decode_forward(p: _Packed, seed: int, st: TrainStatics):
    """K5 forward on the card, on the tensor cores
    (``generic_train_fwd_tc_kernel``, in the pack's dtype): y (n_out, M)
    float32 and the gated activations of the hidden layers, each (out_pad,
    M), bf16 on a bf16 pack."""
    e, m = p.x0_t.shape
    dev = p.x0_t.device
    bf16 = p.dtype == torch.bfloat16
    y = torch.empty((p.out_pads[-1], m), dtype=torch.float32, device=dev)
    acts = [torch.empty((h, m), dtype=p.dtype, device=dev) for h in p.out_pads[:-1]]
    desc = _descriptor(p, st, y, acts)
    _run("generic_train_decoder_fwd", _lib().generic_train_decoder_fwd, dev, desc.ctypes.data,
         int(desc.size), seed & _M32, gate_threshold(st.keep), float(np.float32(1.0 / st.keep)),
         int(bf16))
    if bf16:
        generic_train_decode.bf16_launches += 1
    else:
        generic_train_decode.launches += 1
    return y, acts


def generic_train_decode_backward(p: _Packed, st: TrainStatics, y: torch.Tensor,
                                  acts: List[torch.Tensor], dy: torch.Tensor,
                                  dx_last: Optional[torch.Tensor] = None):
    """K5 backward on the card: the reverse chain per 64-point tile on the
    tensor cores (adding ``dx_last`` (M, h), if given, to the final layer's
    input gradient, then writing each layer's pre-activation gradient and
    d(x0)), then per layer the weight, input-weight and bias reductions over
    all M points.  On a bf16 pack the chain writes each pre-activation
    gradient twice, float32 for the bias sums and rounded to bf16 for the
    products' reductions.  Returns (dx0 (M, e), a view of (e, M), [(dW |
    None, dX | None, db)] padded; a stacked X_0's dX is the one reduction,
    the same for both of its weights)."""
    e, m = p.x0_t.shape
    dev = p.x0_t.device
    bf16 = p.dtype == torch.bfloat16
    dy = dy.to(torch.float32).contiguous()
    if dx_last is not None:
        dx_last = dx_last.to(torch.float32).contiguous()
        if dx_last.shape[0] != m or not 1 <= dx_last.shape[1] <= p.out_pads[-2]:
            raise ValueError(f"dx_last {tuple(dx_last.shape)} does not fit the trunk")
    dx0 = torch.empty((e, m), dtype=torch.float32, device=dev)
    dpre = [torch.empty((h, m), dtype=torch.float32, device=dev) for h in p.out_pads]
    dpre16 = ([torch.empty((h, m), dtype=torch.bfloat16, device=dev) for h in p.out_pads]
              if bf16 else None)
    grads = []
    for layer in range(len(p.b)):
        dw = None if p.w[layer] is None else torch.zeros_like(p.w[layer])
        dx = (torch.zeros((e, p.out_pads[layer]), dtype=torch.float32, device=dev)
              if p.has_x[layer] else None)
        grads.append((dw, dx, torch.zeros_like(p.b[layer])))
    desc = _descriptor(p, st, y, acts, dy=dy, dx0=dx0, dpre=dpre, grads=grads, dx_last=dx_last,
                       dpre16=dpre16)
    _run("generic_train_decoder_bwd", _lib().generic_train_decoder_bwd, dev, desc.ctypes.data,
         int(desc.size), float(np.float32(1.0 / st.keep)), int(bf16))
    if bf16:
        generic_train_decode_backward.bf16_launches += 1
    else:
        generic_train_decode_backward.launches += 1
    return dx0.T, grads


class GenericTrainDecodeFunction(torch.autograd.Function):
    """K5 over one trunk: (y, x_last).  Inputs are unpadded, as the plain
    version takes them, flattened as (x0, ws that exist, xs that exist, bs);
    the padding happens here and the padded rows and columns of every
    gradient are dropped on the way out.  The gated activations are the
    residuals; x_last is a view of the last one (in bf16 a float32 copy, so
    that its gradient stays float32).  The backward takes dx_last = None
    when x_last fed nothing (no classifier)."""

    @staticmethod
    def forward(ctx, st: TrainStatics, seed: int, x0: torch.Tensor, *params):
        ws, xs, bs = unflatten_params(st, params)
        packed = pack_generic_trunk(x0.detach(), [None if w is None else w.detach() for w in ws],
                                    [None if x is None else x.detach() for x in xs],
                                    [b.detach() for b in bs], st)
        y, acts = generic_train_decode_forward(packed, seed, st)
        ctx.st, ctx.packed, ctx.acts, ctx.y = st, packed, acts, y
        ctx.shapes = ([None if w is None else w.shape for w in ws],
                      [None if x is None else x.shape for x in xs], [b.shape for b in bs])
        ctx.set_materialize_grads(False)
        return y, acts[-1][:bs[-2].shape[-1]].T.to(torch.float32)

    @staticmethod
    def backward(ctx, dy: Optional[torch.Tensor], dx_last: Optional[torch.Tensor]):
        if dy is None:
            dy = torch.zeros_like(ctx.y)
        dx0, grads = generic_train_decode_backward(ctx.packed, ctx.st, ctx.y, ctx.acts, dy,
                                                   dx_last)
        w_shapes, x_shapes, b_shapes = ctx.shapes
        e = dx0.shape[1]
        d_w = [dw[:s[0], :s[1]] for (dw, _, _), s in zip(grads, w_shapes) if s is not None]
        d_x = [dx[:, :s[1]].repeat(s[0] // e, 1) for (_, dx, _), s in zip(grads, x_shapes)
               if s is not None]
        d_b = [db[:s[-1]] for (_, _, db), s in zip(grads, b_shapes)]
        return (None, None, dx0, *d_w, *d_x, *d_b)


def generic_train_decode(x0: torch.Tensor, ws: Sequence[Optional[torch.Tensor]],
                         xs: Sequence[Optional[torch.Tensor]], bs: Sequence[torch.Tensor],
                         seed: int, st: TrainStatics) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5: the (n_out, M) tanh'd outputs of one trunk and x_last (M, h),
    both differentiable in x0 and every weight and bias, in ``st.dtype``'s
    contract."""
    if x0.device.type == "cpu":
        if st.dtype == torch.float32:
            return generic_train_decode_reference(x0, ws, xs, bs, seed, st)
        return TrainDecodeReference.apply(st, seed, x0, *flatten_params(ws, xs, bs))
    if x0.device.type != "cuda":
        raise ValueError(f"generic_train_decode runs on cuda or cpu, not {x0.device}")
    return GenericTrainDecodeFunction.apply(st, seed, x0, *flatten_params(ws, xs, bs))


generic_train_decode.launches = 0
generic_train_decode_backward.launches = 0
generic_train_decode.bf16_launches = 0
generic_train_decode_backward.bf16_launches = 0
