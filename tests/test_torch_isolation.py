"""The PyTorch port stands alone: no module of ``alignsdf_torch`` (nor
``chip_smoke.py``, nor the port's packers ``tools/create_lmdb_torch.py`` and
``tools/pack_dataset_torch.py``)
imports JAX, flax, orbax, cv2 or the JAX package, and its entry points refuse
to fall back to the CPU on their own."""

import ast
import os
import pkgutil
import subprocess
import sys

import pytest
import torch

import alignsdf_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "cv2", "alignsdf_tpu")


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(alignsdf_torch.__path__, "alignsdf_torch."))


def test_every_module_imports_with_jax_blocked():
    modules = _port_modules()
    assert "alignsdf_torch.kernels.grid_decoder" in modules
    assert "alignsdf_torch.kernels.pixel_train_decoder" in modules
    assert "alignsdf_torch.ops.pixel_train_plan" in modules
    for name in ("kernels.generic_decoder", "kernels.generic_train_decoder", "ops.decoder_plan",
                 "ops.generic_train_plan", "kernels.maxpool", "data.sdf_samples",
                 "data.lmdb_format", "data.lmdb_backend", "data.img_utils", "data.backends",
                 "data.dataset", "data.loader", "utils.metrics", "kernels.weight_grad",
                 "eval.chamfer", "eval.icp", "eval.evaluate", "cli.evaluate", "cli.reconstruct",
                 "cli.train", "data.synthetic", "data.packed", "native"):
        assert f"alignsdf_torch.{name}" in modules
    code = (
        "import sys\n"
        f"for name in {BLOCKED!r}:\n"
        "    sys.modules[name] = None\n"
        "import importlib\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "sys.path.insert(0, 'tools')\n"
        "import create_lmdb_torch\n"
        "import pack_dataset_torch\n"
        "print('imported', len(sys.modules))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "imported" in res.stdout


def _python_sources():
    root = os.path.join(REPO, "alignsdf_torch")
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)
    yield os.path.join(REPO, "chip_smoke.py")
    yield os.path.join(REPO, "tools", "create_lmdb_torch.py")
    yield os.path.join(REPO, "tools", "pack_dataset_torch.py")


def test_no_source_names_a_blocked_module():
    """Static check, so an import inside a function body is caught too."""
    for path in _python_sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for name in names:
                assert name.split(".")[0] not in BLOCKED, f"{path} imports {name}"


def test_reconstructor_without_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid here")
    from alignsdf_torch.config import Specs, NetworkSpecs
    from alignsdf_torch.inference.reconstruct import Reconstructor
    from alignsdf_torch.models.alignsdf import build_model

    specs = Specs(latent_size=8, network_specs=NetworkSpecs(dims=(16, 16, 16, 16)))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Reconstructor(build_model(specs), specs, cube_dim=8)


def test_chip_smoke_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present")
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
