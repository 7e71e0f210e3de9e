"""Host-side half of the pixel-aligned train decoder: materialize the
weight-norm layers, split each trunk's weights into the operands of kernel
K4, lay the HeadNet map out as a channel-contiguous table with its mean, and
project the points into the map.

Counterpart of ``split_trunk`` and ``decode`` in the JAX package's
``make_fused_train_decoder_pixel`` (``ops/decoder_train_pixel.py:785-1028``),
with its ``band`` (an explicit int) and ``presorted``: the band goes to K4's
backward (its banded tap stage), and without ``presorted`` the decode sorts
each scene's points by feature row first, as JAX's does.  Everything here
is plain PyTorch outside K4's autograd Function,
so autograd carries the gradients of ``weight_v``, ``weight_g`` and the
biases, of the map through the table and its mean, and of the predicted
hand root through the projection.  With a classifier, K4 also gives the
first trunk's x_last, and the logits are one torch.matmul outside the
kernel (``train_plan.classify``), as the JAX package's ``classifier_apply``
(:890-895) is XLA outside its kernel.

The statics carry the spec's compute dtype, so that a bf16 spec runs K4's
bf16 contract (the JAX factory passes ``specs.compute_dtype`` at :1007);
the table and its mean stay float32, as the JAX factory casts the map to
float32 before its kernel, and autograd through that cast rounds d(map)
to bf16 where the map is bf16, as JAX's does.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch

from alignsdf_torch.config import Specs
from alignsdf_torch.kernels.pixel_train_decoder import (
    PixelTrainStatics,
    Trunk,
    band_rows_max,
    pixel_train_decode,
)
from alignsdf_torch.models.decoder import trunk_layer_dims, trunk_prefixes
from alignsdf_torch.models.layers import compute_dtype_of, materialize_linear
from alignsdf_torch.ops.geometry import pixel_coords
from alignsdf_torch.ops.grid_plan import branch_columns
from alignsdf_torch.ops.train_plan import classify


def pixel_trunk_operands(decoder: torch.nn.Module, prefix: str, cols: Sequence[int], c: int,
                         pfs: int, specs: Specs, out_dim: int) -> Trunk:
    """(ws, lats, xs, bs) of one trunk for K4: ws[l] (in, out) on the previous
    activation or None; at layer 0 and the latent_in layers lats[l] (c, out)
    on the latent and xs[l] (pfs, out) on the full embedding, the trunk's
    ``cols`` rows filled and the others zero; bs[l] (out,)."""
    ns = specs.network_specs
    in_dim = c + len(cols)
    shapes = trunk_layer_dims(in_dim, ns, out_dim)
    ws: List[Optional[torch.Tensor]] = []
    lats: List[Optional[torch.Tensor]] = []
    xs: List[Optional[torch.Tensor]] = []
    bs: List[torch.Tensor] = []
    cur = in_dim
    for layer in range(len(shapes)):
        weight, bias = materialize_linear(getattr(decoder, f"{prefix}{layer}"))
        w = weight.T  # (in, out)
        src = None
        if layer == 0:
            ws.append(None)
            src = w
        elif layer in ns.latent_in:
            # the torch layer's input was [x (cur), latent (c), emb (len(cols))]
            ws.append(w[:cur])
            src = w[cur:cur + in_dim]
        else:
            ws.append(w)
        if src is None:
            lats.append(None)
            xs.append(None)
        else:
            idx = torch.as_tensor(cols, dtype=torch.long, device=w.device)
            lats.append(src[:c])
            xs.append(src.new_zeros((pfs, src.shape[1])).index_copy(0, idx, src[c:in_dim]))
        bs.append(bias)
        cur = shapes[layer][1]
    return ws, lats, xs, bs


def pixel_trunks(decoder: torch.nn.Module, specs: Specs, c: int) -> List[Trunk]:
    """K4's operands of the decoder's trunks for a c-channel map: the one
    combined trunk with two outputs, or the hand and object trunks."""
    cols_h, cols_o = branch_columns(specs)
    pfs = specs.point_feat_size
    first, second = trunk_prefixes(decoder)
    if second is None:
        return [pixel_trunk_operands(decoder, first, cols_h, c, pfs, specs, 2)]
    return [pixel_trunk_operands(decoder, first, cols_h, c, pfs, specs, 1),
            pixel_trunk_operands(decoder, second, cols_o, c, pfs, specs, 1)]


def pixel_train_inputs(fmap: torch.Tensor, xyz: torch.Tensor, cam_intr: torch.Tensor,
                       pred_root: torch.Tensor, specs: Specs):
    """(table (B, HW, C), mean (B, C), xp, yp, mask (M,)) of K4 from the map
    (B, C, Hf, Wf) and the points' projection, all differentiable: the
    table is the map with channels contiguous, the mean is taken over the
    table's pixels as the JAX decode takes it."""
    b, c, hf, wf = fmap.shape
    table = fmap.to(torch.float32).reshape(b, c, hf * wf).transpose(1, 2).contiguous()
    xp, yp, mask = pixel_coords(xyz, cam_intr, pred_root, specs.image_size[0],
                                specs.sdf_scale_factor, hf, wf)
    return table, table.mean(dim=1), xp.reshape(-1), yp.reshape(-1), mask.reshape(-1)


def scene_block(n: int, cap: int) -> Optional[int]:
    """The TPU kernel's block of a scene's n points: the largest divisor of
    n that is a multiple of 16 and at most ``cap``, or None (JAX
    ``ops/decoder_train_kernel.py:752 _scene_block``).  The port's kernels
    run 64-point tiles; this rule only decides where the banded decode
    sorts, as JAX's does (``decoder_train_pixel.py:952-954``)."""
    best = None
    for b in range(16, cap + 1, 16):
        if n % b == 0:
            best = b
    return best


def default_band(specs: Specs) -> int:
    """The band ``cli.train --pixel_band`` gives K4: the largest the
    backward's tap stage holds (``band_rows_max``) up to half the HeadNet
    map's rows (image_size // 4, the rows the host sort keys on), JAX's
    "auto" (``decoder_train_pixel.py:952``)."""
    rows = specs.image_size[0] // 4
    band = min(rows // 2, band_rows_max(specs.image_size[1] // 4, specs.latent_size))
    if band < 1:
        raise ValueError(f"a {rows}-row map leaves K4's tap stage no band")
    return band


def sort_by_row(yp: torch.Tensor, mask: torch.Tensor, b: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(perm, inv) (M,): each scene's points in ascending yp, stably, those
    outside the image (key 1e9) last, as JAX's device sort
    (``decoder_train_pixel.py:957-975``); ``x[perm]`` sorts, ``x[inv]``
    restores."""
    key = torch.where(mask > 0, yp, torch.full_like(yp, 1e9)).reshape(b, -1)
    n = key.shape[1]
    order = torch.argsort(key, dim=1, stable=True)
    perm = (order + torch.arange(b, device=yp.device)[:, None] * n).reshape(-1)
    return perm, torch.empty_like(perm).scatter_(0, perm, torch.arange(
        perm.shape[0], device=perm.device))


def make_pixel_train_decoder(specs: Specs, kernel: Callable = pixel_train_decode,
                             band: Optional[int] = None, presorted: bool = False,
                             block_cap: int = 2000) -> Optional[Callable]:
    """decode(decoder, fmap (B, C, Hf, Wf), emb (M, pfs), xyz (M, 3), cam_intr
    (B, 3, 3+), pred_root (B, 1, 3), seed, train) -> (sdf_h (M,), sdf_o
    (M,), logits (M, C) or None) through K4, or None for a structure K4
    does not take: the JAX factory's refusals less the TPU's block-size
    rule (0 in ``latent_in`` among them; a latent input at the final layer is
    taken, as JAX's, :842-844).
    Both trunks draw their dropout from ``seed``, the object trunk hashing
    layer + n_layers.  ``kernel`` may name K4's plain version instead, to
    compare the two on the card.  ``decode.pixel`` is True: the train step
    feeds it ``decoder_inputs_pixel``.

    ``band`` (an int or None, never "auto") and ``presorted`` are JAX's
    (:785-1028).  presorted: the batch's points are already in row order
    (``data/pixel_sort.py``), K4 runs on them as they are and takes the
    band.  Otherwise the decode sorts where JAX's would: with a band and
    more than one TPU block a scene (``scene_block(n, block_cap)``,
    block_cap 2000 meaning 400 under a band, :845-847), it runs K4 on each
    scene's points sorted by yp (``sort_by_row``), so the dropout gate
    hashes the sorted positions, with the band, and puts y and x_last back
    in the batch's order (:1016-1019); elsewhere it runs K4 unbanded.
    ``block_cap`` serves only that rule."""
    if band is not None and (not isinstance(band, int) or isinstance(band, bool) or band < 1):
        raise ValueError(f"band {band!r}: a positive int or None")
    ns = specs.network_specs
    n_layers = len(ns.dims) + 1
    if (not specs.pixel_align or not ns.weight_norm or ns.use_tanh or ns.latent_dropout
            or ns.xyz_in_all or 0 in ns.latent_in):
        return None
    x0 = tuple(layer == 0 or layer in ns.latent_in for layer in range(n_layers))
    statics = PixelTrainStatics(
        n_per_scene=specs.samples_per_scene,
        feat_hw=(0, 0),
        has_w=tuple(layer > 0 for layer in range(n_layers)),
        has_x=x0,
        dropout=tuple(bool(ns.dropout) and layer in ns.dropout for layer in range(n_layers - 1)),
        keep=1.0 - ns.dropout_prob,
        train=True,
        layer_offsets=(0,) if specs.model_type == "1encoder1decoder" else (0, n_layers),
        dtype=compute_dtype_of(specs.compute_dtype))
    if band is not None and block_cap == 2000:
        block_cap = 400
    block = scene_block(specs.samples_per_scene, block_cap)
    sort = (band is not None and not presorted and block is not None
            and specs.samples_per_scene // block > 1)
    kernel_band = band if presorted or sort else None

    def decode(decoder, fmap: torch.Tensor, emb: torch.Tensor, xyz: torch.Tensor,
               cam_intr: torch.Tensor, pred_root: torch.Tensor, seed: int,
               train: bool = True
               ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
        b, c, hf, wf = fmap.shape
        table, mean, xp, yp, mask = pixel_train_inputs(fmap, xyz, cam_intr, pred_root, specs)
        st = statics._replace(feat_hw=(hf, wf), train=bool(train), band=kernel_band)
        emb = emb.to(torch.float32)
        if sort:
            perm, inv = sort_by_row(yp.detach(), mask, b)
            xp, yp, mask, emb = xp[perm], yp[perm], mask[perm], emb[perm]
        y, x_last = kernel(table, mean, xp, yp, mask, emb.contiguous(),
                           pixel_trunks(decoder, specs, c), seed, st)
        if sort:
            y, x_last = y[:, inv], x_last[inv]
        return y[0], y[1], classify(decoder, x_last)

    decode.pixel = True
    decode.statics = statics
    decode.band = kernel_band
    decode.presorted = presorted
    decode.sorts = sort
    return decode
