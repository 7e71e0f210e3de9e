"""Kernel K3: the fused pixel-aligned SDF grid decoder, its packed plan, its
plain PyTorch version and the wrapper that launches the CUDA kernel.

Replaces ``alignsdf_tpu/ops/decoder_kernel.py:make_fused_pixel_grid_kernel_t``.
For a run of ``m`` contiguous linear grid indices from ``base`` (z fastest)
it derives xyz, projects each point into the image, takes as its latent the
bicubic sample of the feature map there (or the map's mean for a point
outside the image), runs the trunks and returns an (n_rows, m) float32
array: row 0 the hand SDF, row 1 the object SDF (both tanh'd), rows 2.. the
classifier's logits, which the plan packs as extra final rows of the first
trunk (``ops/pixel_grid_plan.py``), as K1's does.  The CUDA source is
``csrc/pixel_grid_decoder.cu``, on K1's tensor-core trunk
(``csrc/grid_trunk_tc.cuh``): a layer's activation and latent weights are
stored as one run of ``tile_weights`` tiles, [W; W_lat], since the kernel
gathers the latent into the activation rows just above the layer's input
and runs one product over both.

A plan packed with ``dtype=torch.bfloat16`` is JAX's bf16 K3
(``make_fused_pixel_grid_decode_fn(..., dtype=jnp.bfloat16)``): bf16 tiles
(hidden, latent and final weights), float32 biases and xyz weights (JAX's
``build_pixel_grid_branch_plan`` keeps its xyz weights float32, :847-848,
unlike K1's fold), the feature table and its mean row rounded to bf16
(:997-998), each tap
weight ky kx formed in float32 and rounded (:1103, :1116), the sampled
latent rounded before the trunks (:1122), the hidden activations rounded
after the ReLU; the plain version emulates it in float32.

``pixel_grid_decode`` takes the plain version only for a plan on the CPU;
for a plan on the GPU it launches the kernel or raises.
``pixel_grid_decode.launches`` counts kernel launches.
``pixel_grid_decode.bf16_launches`` counts the bf16 kernel's (a bf16 plan's)
launches apart.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from alignsdf_torch.kernels.grid_decoder import (
    N_ROWS,
    TC_GROUP,
    GridPlan,
    _round_up,
    check_dtype,
    grid_coords,
    k_step,
    output_rows,
    pack_trunks,
    place_tc_layer,
    round_to,
)
from alignsdf_torch.ops.geometry import bicubic_gather

N_PROJ = 28     # projection scalars, laid out as in make_pixel_projection


class PixelHiddenLayer(NamedTuple):
    """One hidden layer: relu(b + a @ w + latent @ lat + xyz @ x)."""

    w: Optional[torch.Tensor]    # (in, out); None for layer 0
    lat: Optional[torch.Tensor]  # (C, out) or None
    x: Optional[torch.Tensor]    # (3, out) or None
    b: torch.Tensor              # (out,)


class PixelTrunk(NamedTuple):
    """A trunk whose embedding is folded into xyz weights and biases and
    whose latent stays an input: hidden layers, then ``fin @ a + fin_x @
    xyz + fin_lat @ latent + fin_b`` written to output ``rows``."""

    hidden: List[PixelHiddenLayer]
    fin: torch.Tensor              # (last_in, len(rows)), columns in row order
    fin_x: Optional[torch.Tensor]  # (3, len(rows)) or None
    fin_b: torch.Tensor            # (len(rows),)
    rows: Sequence[int]
    fin_lat: Optional[torch.Tensor] = None  # (C, len(rows)) of a latent_in final layer, or None


@dataclass
class PixelGridPlan(GridPlan):
    """Trunks packed into one float32 buffer in the kernel's layout, the
    feature table and the projection scalars.

    ``desc`` is the int32 layout descriptor ``pixel_grid_decoder.cu`` reads:
    [n_trunks, fin_b, rows, C, lat_pad, Hf, Wf, n_rows, fin_lat of trunk 0
    and of trunk 1, then per trunk n_hidden, fin, fin_xyz, last_pad, then
    per hidden layer w, x, lat, b, in_pad, out_pad] (offsets in floats, -1
    = absent; fin_lat the (n_rows, lat_pad) latent weights of a latent_in
    final layer; rows = the
    activation buffer's, the widest layer output or input with its latent
    rows).  A layer's hidden weights (in_pad, out_pad) and latent weights
    (lat_pad, out_pad) are one run of ``tile_weights`` tiles, the latent's
    from ``lat`` on; its bias and xyz weights one ``epilogue_tile`` at b (x
    = b + TC_MAX_OUT, or -1); final rows (n_rows, last_pad).  ``table`` is
    the (Hf * Wf + 1, C) map, channels contiguous, then its mean row.
    """

    table: torch.Tensor
    proj: torch.Tensor

    _HEAD = 10
    _LAYER = 6

    @property
    def n_rows(self) -> int:
        return int(self.desc[7])

    @property
    def feat_hw(self) -> Tuple[int, int]:
        return int(self.desc[5]), int(self.desc[6])

    def trunks(self):
        """Yield (hidden [(w|None, lat|None, x|None, b)], fin, fin_xyz|None):
        views, but w and lat untiled (copies)."""
        d = self.desc.tolist()
        lat_pad, n_rows = d[4], self.n_rows
        pos = self._HEAD
        for _ in range(d[0]):
            n_hidden, fin, fin_xyz, last_pad = d[pos:pos + 4]
            pos += 4
            hidden = []
            for _ in range(n_hidden):
                w, x, lat, b, in_pad, out_pad = d[pos:pos + 6]
                pos += 6
                hidden.append((self.weights(w, in_pad, out_pad) if w >= 0 else None,
                               self.weights(lat, lat_pad, out_pad) if lat >= 0 else None,
                               self.xyz_weights(x, out_pad) if x >= 0 else None,
                               self.view(b, (out_pad,))))
            yield (hidden, self.view(fin, (n_rows, last_pad)),
                   self.view(fin_xyz, (n_rows, 3)) if fin_xyz >= 0 else None)

    def fin_lats(self) -> List[Optional[torch.Tensor]]:
        """Per trunk, the (n_rows, lat_pad) latent weights of its final layer
        (a view), or None."""
        d = self.desc.tolist()
        return [self.view(off, (self.n_rows, d[4])) if off >= 0 else None
                for off in d[8:8 + d[0]]]


def make_pixel_projection(a_proj: torch.Tensor, b_proj: torch.Tensor, cam: torch.Tensor,
                          root: torch.Tensor, sdf_scale_factor: float, feat_hw: Tuple[int, int],
                          image_size: int) -> torch.Tensor:
    """The (28,) float32 projection scalars: [0:9] A row-major and [9:12] b of
    the projected point e = xyz @ A + b; [12:21] the camera K row-major;
    [21:24] the hand root; then 2 / sdf_scale_factor, (Wf - 1) / image_size,
    (Hf - 1) / image_size and image_size (JAX decoder_kernel.py:1345-1352)."""
    hf, wf = feat_hw
    tail = torch.tensor([2.0 / sdf_scale_factor, (wf - 1) / image_size,
                         (hf - 1) / image_size, float(image_size)], dtype=torch.float32)
    return torch.cat([a_proj.reshape(9).float(), b_proj.reshape(3).float(),
                      cam.reshape(9).float(), root.reshape(3).float(),
                      tail.to(a_proj.device)]).contiguous()


def make_feature_table(fmap: torch.Tensor) -> torch.Tensor:
    """(1, C, Hf, Wf) map -> (Hf * Wf + 1, C) float32: pixels row-major with
    channels contiguous, then the mean feature."""
    _, c, hf, wf = fmap.shape
    rows = fmap[0].to(torch.float32).reshape(c, hf * wf).T
    return torch.cat([rows, rows.mean(dim=0, keepdim=True)], dim=0).contiguous()


def pack_pixel_grid_plan(trunks: List[PixelTrunk], table: torch.Tensor, proj: torch.Tensor,
                         feat_hw: Tuple[int, int], n: int,
                         dtype: torch.dtype = torch.float32) -> PixelGridPlan:
    """Pad and pack trunks into a PixelGridPlan on the trunks' device, with
    ``output_rows(trunks)`` output rows (the class rows on the first
    trunk), computing in ``dtype`` (the table rounded to it; the latent
    rows pad to its k step)."""
    hf, wf = feat_hw
    c = table.shape[1]
    if table.shape[0] != hf * wf + 1:
        raise ValueError(f"a {hf}x{wf} map needs {hf * wf + 1} table rows, got {table.shape[0]}")
    if proj.shape != (N_PROJ,):
        raise ValueError(f"the projection has {N_PROJ} scalars, got {tuple(proj.shape)}")
    lat_align = k_step(dtype)  # the latent rows pad to the kernel's k step
    lat_pad = _round_up(c, lat_align)
    n_rows = output_rows(trunks)

    rows = 0

    def layer(place, h: PixelHiddenLayer, in_pad: int, out_pad: int) -> List[int]:
        nonlocal rows
        if h.lat is not None:
            rows = max(rows, (in_pad if h.w is not None else 0) + lat_pad)
        return place_tc_layer(place, h.w, h.lat, h.x, h.b, in_pad, out_pad, lat_pad, dtype,
                              xyz_dtype=torch.float32)

    def pad_lat(t: PixelTrunk) -> PixelTrunk:
        if t.fin_lat is None:
            return t
        return t._replace(fin_lat=torch.cat([t.fin_lat, t.fin_lat.new_zeros(lat_pad - c,
                                                                            len(t.rows))]))

    flat, desc = pack_trunks([pad_lat(t) for t in trunks], layer,
                             (c, lat_pad, hf, wf, n_rows, -1, -1), n_rows, TC_GROUP, dtype,
                             fin_x_dtype=torch.float32, fin_lat_at=8)
    desc[2] = max(int(desc[2]), _round_up(rows, lat_align))
    device = flat.device
    table = round_to(table.to(device=device, dtype=torch.float32), dtype).contiguous()
    return PixelGridPlan(flat, desc, n, table,
                         proj.to(device=device, dtype=torch.float32).contiguous(),
                         dtype=check_dtype(dtype))


def pixel_projection(plan: PixelGridPlan, base: int, m: int, origin: torch.Tensor,
                     voxel: torch.Tensor):
    """(xyz (m, 3), xp (m,), yp (m,), in_image (m,) bool) of grid indices
    base..base+m: the kernel's projection, one rounding per operation in the
    kernel's order, so that both agree bit for bit on which points lie in
    the image.  xp, yp are 0 outside it."""
    xyz = grid_coords(base, m, plan.n, origin, voxel)
    p = plan.proj
    x, y, z = xyz.unbind(1)
    e = [p[j] * x + p[3 + j] * y + p[6 + j] * z + p[9 + j] for j in range(3)]
    cam = [e[j] * p[24] + p[21 + j] for j in range(3)]
    xh, yh, zh = (p[12 + 3 * r] * cam[0] + p[13 + 3 * r] * cam[1] + p[14 + 3 * r] * cam[2]
                  for r in range(3))
    inv = 1.0 / zh
    xi, yi = xh * inv, yh * inv
    size = p[27]
    inside = (xi >= 0.0) & (xi <= size) & (yi >= 0.0) & (yi <= size) & (zh != 0.0)
    zero = torch.zeros_like(xi)
    return (xyz, torch.where(inside, xi * p[25], zero), torch.where(inside, yi * p[26], zero),
            inside)


def pixel_grid_decode_reference(plan: PixelGridPlan, base: int, m: int, origin: torch.Tensor,
                                voxel: torch.Tensor) -> torch.Tensor:
    """The plain version of K3: the same projection, the 16-tap bicubic
    gather of the table, and the trunks with torch.matmul (a bf16 plan's tap
    weights, sampled latent and hidden activations rounded to bf16).
    Returns (n_rows, m) float32, tanh on the SDF rows."""
    xyz, xp, yp, inside = pixel_projection(plan, base, m, origin, voxel)
    hf, wf = plan.feat_hw
    c = plan.table.shape[1]
    sampled = bicubic_gather(plan.table[None], xp[None], yp[None], hf, wf, plan.dtype)[0]
    latent = torch.where(inside[:, None], round_to(sampled, plan.dtype),
                         plan.table[hf * wf][None, :])
    lat_pad = int(plan.desc[4])
    if lat_pad > c:
        latent = torch.nn.functional.pad(latent, (0, lat_pad - c))
    acc = plan.fin_b[:, None].expand(plan.n_rows, m).clone()
    for (hidden, fin, fin_xyz), fin_lat in zip(plan.trunks(), plan.fin_lats()):
        a = None
        for w, lat, x, b in hidden:
            h = b[None, :]
            if w is not None:
                h = h + a @ w
            if lat is not None:
                h = h + latent @ lat
            if x is not None:
                h = h + xyz @ x
            a = round_to(torch.relu(h), plan.dtype)
        acc = acc + fin @ a.T
        if fin_xyz is not None:
            acc = acc + fin_xyz @ xyz.T
        if fin_lat is not None:
            acc = acc + fin_lat @ latent.T
    return torch.cat([torch.tanh(acc[:N_ROWS]), acc[N_ROWS:]])


def _launcher():
    from alignsdf_torch.kernels.build import load

    lib = load("pixel_grid_decoder")
    fn = lib.pixel_grid_decoder_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    return fn


def pixel_grid_decode(plan: PixelGridPlan, base: int, m: int, origin: torch.Tensor,
                      voxel: torch.Tensor) -> torch.Tensor:
    """K3: (n_rows, m) float32 SDFs (and logits) of grid indices
    base..base+m."""
    if plan.device.type == "cpu":
        return pixel_grid_decode_reference(plan, base, m, origin, voxel)
    if plan.device.type != "cuda":
        raise ValueError(f"pixel_grid_decode runs on cuda or cpu, not {plan.device}")
    for name, t in (("plan", plan.flat), ("table", plan.table), ("proj", plan.proj)):
        if t.device != plan.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"the {name} must be contiguous float32 on {plan.device}")
    if plan.flat.data_ptr() % 16:
        raise ValueError("the plan buffer must be 16-byte aligned")
    if m <= 0 or base < 0 or base + m > plan.n ** 3 or plan.n ** 3 >= 2 ** 31:
        raise ValueError(f"index run [{base}, {base + m}) outside the {plan.n}^3 grid")
    scal = torch.cat([torch.as_tensor(origin, dtype=torch.float32).reshape(3).to(plan.device),
                      torch.as_tensor(voxel, dtype=torch.float32).reshape(1).to(plan.device),
                      plan.proj]).contiguous()
    out = torch.empty((plan.n_rows, m), dtype=torch.float32, device=plan.device)
    desc = np.ascontiguousarray(plan.desc, np.int32)
    with torch.cuda.device(plan.device):
        stream = torch.cuda.current_stream(plan.device).cuda_stream
        rc = _launcher()(plan.flat.data_ptr(), desc.ctypes.data, int(desc.size),
                         plan.table.data_ptr(), scal.data_ptr(), int(base), int(m),
                         int(plan.n), out.data_ptr(), int(plan.dtype == torch.bfloat16),
                         stream)
    if rc != 0:
        raise RuntimeError(f"pixel_grid_decoder launch failed with code {rc}"
                           + (" (plan rejected)" if rc == -1 else ""))
    if plan.dtype == torch.bfloat16:
        pixel_grid_decode.bf16_launches += 1
    else:
        pixel_grid_decode.launches += 1
    return out


pixel_grid_decode.launches = 0
pixel_grid_decode.bf16_launches = 0  # the bf16 kernel's (a bf16 plan's) launches
