"""JAX parameter tree -> torch state_dict for ``models.alignsdf.AlignSDF``.

The inverse of the JAX package's ``models/torch_import.py``:
  flax Linear kernel (in, out)         -> weight (out, in)
  weight-norm {v (in, out), g (out,)}  -> weight_v (out, in), weight_g (out, 1)
  Conv kernel (kH, kW, I, O)           -> weight (O, I, kH, kW)
  ConvTranspose kernel (kH, kW, I, O)  -> weight (I, O, kH, kW)
  BN params {scale, bias} + batch_stats {mean, var}
      -> weight, bias, running_mean, running_var, num_batches_tracked
Inputs are nested dicts of numpy-convertible arrays; the keys produced are the
reference checkpoint's, so the result loads with ``load_state_dict``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from alignsdf_torch.config import Specs


def _t(a: Any) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _linear(sd: Dict[str, torch.Tensor], prefix: str, p: Mapping[str, Any]) -> None:
    if "v" in p:
        sd[f"{prefix}.weight_v"] = _t(p["v"]).T.contiguous()
        sd[f"{prefix}.weight_g"] = _t(p["g"]).reshape(-1, 1)
    else:
        sd[f"{prefix}.weight"] = _t(p["kernel"]).T.contiguous()
    if "bias" in p:
        sd[f"{prefix}.bias"] = _t(p["bias"])


def _conv(sd, prefix: str, p: Mapping[str, Any], transpose: bool = False) -> None:
    perm = (2, 3, 0, 1) if transpose else (3, 2, 0, 1)
    sd[f"{prefix}.weight"] = _t(p["kernel"]).permute(*perm).contiguous()
    if "bias" in p:
        sd[f"{prefix}.bias"] = _t(p["bias"])


def _bn(sd, prefix: str, p: Mapping[str, Any], s: Mapping[str, Any]) -> None:
    sd[f"{prefix}.weight"] = _t(p["scale"])
    sd[f"{prefix}.bias"] = _t(p["bias"])
    sd[f"{prefix}.running_mean"] = _t(s["mean"])
    sd[f"{prefix}.running_var"] = _t(s["var"])
    sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)


def _encoder(sd, params: Mapping[str, Any], stats: Mapping[str, Any]) -> None:
    pre = "encoder."
    _conv(sd, pre + "conv1", params["conv1"])
    _bn(sd, pre + "bn1", params["bn1"], stats["bn1"])
    for name, block in params.items():
        if not name.startswith("layer"):
            continue
        stage, b = name[len("layer"):].split("_")
        t = f"{pre}layer{stage}.{b}"
        for c in (1, 2):
            _conv(sd, f"{t}.conv{c}", block[f"conv{c}"])
            _bn(sd, f"{t}.bn{c}", block[f"bn{c}"], stats[name][f"bn{c}"])
        if "downsample_conv" in block:
            _conv(sd, f"{t}.downsample.0", block["downsample_conv"])
            _bn(sd, f"{t}.downsample.1", block["downsample_bn"], stats[name]["downsample_bn"])
    if "fc" in params:
        _linear(sd, pre + "fc", params["fc"])
    if "aux_layer" in params:
        head, head_stats = params["aux_layer"], stats["aux_layer"]
        for i in range(3):
            _conv(sd, f"{pre}aux_layer.deconv_layers.{3 * i}", head[f"deconv{i}"], transpose=True)
            _bn(sd, f"{pre}aux_layer.deconv_layers.{3 * i + 1}", head[f"bn{i}"],
                head_stats[f"bn{i}"])


def decoder_from_jax(params: Mapping[str, Any], prefix: str = "") -> Dict[str, torch.Tensor]:
    """A JAX Separate/CombinedDecoder's params -> the port decoder's
    state_dict.  The classifier head of the hand (or combined) trunk becomes
    the decoder's own ``classifier_head``, the reference's key."""
    sd: Dict[str, torch.Tensor] = {}
    for trunk in params.values():
        for name, layer in trunk.items():
            if name.startswith("bn"):
                raise NotImplementedError(f"decoder layer {name!r} is not ported yet")
            _linear(sd, prefix + name, layer)
    return sd


def from_jax(params: Mapping[str, Any], batch_stats: Mapping[str, Any],
             specs: Specs) -> Dict[str, torch.Tensor]:
    """A JAX ``AlignSDF`` (params, batch_stats) -> the reference state_dict."""
    if any(k.startswith("layer") and "conv3" in v
           for k, v in params["encoder"].items() if isinstance(v, Mapping)):
        raise NotImplementedError("bottleneck ResNets are not ported yet")
    sd: Dict[str, torch.Tensor] = {}
    _encoder(sd, params["encoder"], batch_stats["encoder"])

    sd.update(decoder_from_jax(params["decoder"], prefix="decoder."))

    if "mano_decoder" in params:
        mano = params["mano_decoder"]
        _linear(sd, "mano_decoder.base_layer.0", mano["base0"])
        _linear(sd, "mano_decoder.base_layer.2", mano["base1"])
        _linear(sd, "mano_decoder.pose_reg", mano["pose_reg"])
        _linear(sd, "mano_decoder.shape_reg.0", mano["shape_reg"])
        for head in ("trans_branch", "object_rot_branch"):
            if head in mano:
                _linear(sd, f"mano_decoder.{head}.decoder.0", mano[head]["hidden0"])
                _linear(sd, f"mano_decoder.{head}.final_layer", mano[head]["final"])

    if specs.use_obj_pose:
        _conv(sd, "volume_layer", params["volume_layer"])
    return sd
