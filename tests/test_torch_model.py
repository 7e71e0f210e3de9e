"""The port's model against the JAX AlignSDF with the same (converted)
weights: encode_scene at the narrow flagship config, the generic decoder on
random rows, and the state_dict round trip through the JAX package's own
reference-checkpoint importer."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from alignsdf_tpu.config import NetworkSpecs as JaxNetworkSpecs
from alignsdf_tpu.models.decoder import CombinedDecoder as JaxCombined
from alignsdf_tpu.models.decoder import SeparateDecoder as JaxSeparate
from alignsdf_tpu.models.torch_import import convert_alignsdf
from alignsdf_torch.config import NetworkSpecs
from alignsdf_torch.convert import decoder_from_jax
from alignsdf_torch.models.decoder import make_decoder

import torch_parity


@pytest.fixture(scope="module")
def pair():
    return torch_parity.build_pair()


def test_encode_scene_matches_jax(pair):
    """Tolerance 1e-4: a ResNet18 and MANO in float32 accumulate rounding
    differences of the two frameworks' convolutions."""
    jmodel, variables, pmodel, _, _ = pair
    s = torch_parity.make_sample(7)
    args = [s["image"][None], s["cam_intr"][None], s["mano_root"][None],
            s["rest_obj_corners"][None]]
    j_lat, j_mano, j_obj = jax.jit(lambda v, *a: jmodel.apply(
        v, *a, method=jmodel.encode_scene))(variables, *map(jnp.asarray, args))
    p_lat, p_mano, p_obj = pmodel.encode_scene(*map(torch.from_numpy, args))

    def close(j, t):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-4, rtol=0)

    close(j_lat, p_lat)
    for k in ("joints", "verts", "global_trans", "rot_center", "center3d", "obj_rot"):
        close(j_mano[k], p_mano[k])
    for k in ("obj_trans", "obj_corners", "obj_center"):
        close(j_obj[k], p_obj[k])
    # the field has to move: latent and pose are not degenerate
    assert float(np.abs(np.asarray(j_lat)).max()) > 1e-3


@pytest.mark.parametrize("model_type,style,pfs", [
    ("1encoder2decoder", "both", 9), ("1encoder2decoder", "hand", 6),
    ("1encoder2decoder", "nerf", 3), ("1encoder1decoder", "nerf", 3)])
def test_generic_decoder_matches_jax(model_type, style, pfs):
    """Tolerance 1e-5: five float32 layers of width 64."""
    ls = 32
    ns = dict(dims=(64, 64, 64, 64), dropout=(), latent_in=(2,))
    if model_type == "1encoder1decoder":
        jdec = JaxCombined(ls, pfs, style, JaxNetworkSpecs(**ns))
    else:
        jdec = JaxSeparate(ls, pfs, style, JaxNetworkSpecs(**ns))
    rows = np.random.RandomState(3).randn(300, ls + pfs).astype(np.float32)
    params = jdec.init(jax.random.PRNGKey(2), jnp.asarray(rows))["params"]
    j_h, j_o, _ = jdec.apply({"params": params}, jnp.asarray(rows))

    pdec = make_decoder(model_type, ls, pfs, style, NetworkSpecs(**ns))
    pdec.load_state_dict(decoder_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    with torch.no_grad():
        p_h, p_o, _ = pdec(torch.from_numpy(rows))
    np.testing.assert_allclose(p_h.numpy(), np.asarray(j_h), atol=1e-5, rtol=0)
    np.testing.assert_allclose(p_o.numpy(), np.asarray(j_o), atol=1e-5, rtol=0)


def test_state_dict_roundtrips_through_reference_importer(pair):
    """convert_alignsdf (reference checkpoint -> JAX) inverts from_jax: the
    port's state_dict is a reference checkpoint."""
    _, variables, pmodel, jspecs, _ = pair
    params, stats = convert_alignsdf(pmodel.state_dict(), jspecs, (2, 2, 2, 2))
    flat_j = jax.tree_util.tree_leaves_with_path(
        {"params": variables["params"], "batch_stats": variables["batch_stats"]})
    flat_p = dict(jax.tree_util.tree_leaves_with_path({"params": params, "batch_stats": stats}))
    assert len(flat_j) == len(flat_p)
    for path, leaf in flat_j:
        np.testing.assert_array_equal(np.asarray(flat_p[path]), np.asarray(leaf))
