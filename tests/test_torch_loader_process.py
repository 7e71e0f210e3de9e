"""The loader's forked process workers (``worker_mode="process"``, the
train CLI's ``--loader_mode process``) on the CPU: the same batches as
thread workers, bit for bit, from LMDBs, the per-file layout and a pack; a
worker's exception raised again in the parent; a worker that is killed
raising in the parent instead of leaving it waiting; the CLI's losses the
same in both modes.

The loader forks, and a fork of a process that has imported JAX may
deadlock on JAX's threads.  This file imports no JAX, but the tests'
conftest does, and so may other test files run in the same pytest process;
so where JAX is loaded each test here runs in one fresh interpreter with
JAX blocked (one for the file, its result read by each test from its
JUnit XML), and only there are the datasets written and the children
forked."""

import contextlib
import functools
import json
import os
import signal
import subprocess
import sys
import tempfile
import xml.etree.ElementTree as ET

import numpy as np
import pytest
import torch

from alignsdf_torch.cli import train as train_cli
from alignsdf_torch.config import Specs, load_specs
from alignsdf_torch.data import make_train_dataset
from alignsdf_torch.data.dataset import to_train_batch
from alignsdf_torch.data.loader import DataLoader, LoaderWorkerDied
from alignsdf_torch.data.synthetic import write_synthetic_dataset, write_synthetic_lmdb

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
import pack_dataset_torch  # noqa: E402

KEYS = [f"{i:08d}" for i in range(8)]
HW = 64
LIMIT_S = 120  # each test's time limit: a hung parent fails instead of stalling the run
FILE_LIMIT_S = 600  # the JAX-free interpreter's limit for the whole file
BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "alignsdf_tpu")
JAX_FREE = sys.modules.get("jax") is None
_clean: dict = {}


def _clean_results() -> dict:
    """Runs this file once in a fresh interpreter with JAX blocked (without
    the conftest, which imports it) and returns each test's name mapped to
    its failure text, or None where it passed."""
    if not _clean:
        with tempfile.TemporaryDirectory() as tmp:
            _run_clean(os.path.join(tmp, "results.xml"))
    return _clean


def _run_clean(xml: str) -> None:
    code = ("import sys\n"
            f"for name in {BLOCKED!r}:\n"
            "    sys.modules[name] = None\n"
            "import pytest\n"
            f"sys.exit(pytest.main([{__file__!r}, '-q', '--noconftest', '-p', 'no:cacheprovider', "
            f"'-p', 'no:xdist', '-p', 'no:randomly', '--junitxml', {xml!r}]))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=FILE_LIMIT_S)
    _clean["output"] = (res.stdout + res.stderr)[-6000:]
    if os.path.exists(xml):
        for case in ET.parse(xml).getroot().iter("testcase"):
            bad = [c for c in case if c.tag in ("failure", "error", "skipped")]
            _clean[case.get("name")] = (
                None if not bad else "\n".join(f"{c.tag}: {c.get('message')}\n{c.text or ''}"
                                               for c in bad))


def jax_free(test):
    """Runs ``test`` here where no JAX is loaded, else reports its outcome
    in the JAX-free interpreter (``_clean_results``)."""
    @functools.wraps(test)
    def run(*args, **kwargs):
        if JAX_FREE:
            return test(*args, **kwargs)
        name = os.environ["PYTEST_CURRENT_TEST"].split("::")[-1].rsplit(" (", 1)[0]
        results = _clean_results()
        if name not in results:
            pytest.fail(f"{name} did not run in the JAX-free interpreter:\n{results['output']}")
        if results[name] is not None:
            pytest.fail(f"{name} in the JAX-free interpreter:\n{results[name]}")

    return run


@pytest.fixture(autouse=True)
def time_limit():
    if not JAX_FREE:  # the JAX-free interpreter keeps each test's limit
        yield
        return

    def expire(signum, frame):
        raise TimeoutError(f"the test ran past its {LIMIT_S} s limit")

    before = signal.signal(signal.SIGALRM, expire)
    signal.alarm(LIMIT_S)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, before)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """Eight scenes (64x64, 400 SDF rows) as LMDBs, as per-file data and as
    a pack of the per-file data (written only where the tests run)."""
    if not JAX_FREE:
        return None
    root = tmp_path_factory.mktemp("loader")
    lmdb = write_synthetic_lmdb(str(root / "lmdb"), KEYS, n_points=400, image_hw=HW)
    files = write_synthetic_dataset(str(root / "files"), KEYS, n_points=400, image_hw=HW)
    pack = str(root / "train.pack")
    pack_dataset_torch.pack(files, pack, KEYS, "obman")
    return {"lmdb": lmdb, "files": files, "pack": pack}


def _specs(**over):
    base = dict(dataset="obman", sdf_scale_factor=7.0186, samples_per_scene=32,
                image_size=(HW, HW), clamping_distance=0.05)
    return Specs(**dict(base, **over))


def _dataset(roots, layout, specs):
    if layout == "pack":
        return make_train_dataset(specs, None, KEYS, raw_image=True, pack_path=roots["pack"])
    return make_train_dataset(specs, roots[layout], KEYS, raw_image=True)


def _loader(dataset, specs, mode):
    return DataLoader(dataset, batch_size=3, num_workers=2, seed=7, worker_mode=mode,
                      to_batch=lambda s: to_train_batch(specs, s))


@pytest.mark.parametrize("layout", ["lmdb", "files", "pack"])
@jax_free
def test_process_batches_equal_thread_batches(roots, layout):
    """Two epochs of 2 batches of 3 scenes (augmentation on), 2 workers:
    forked processes give the thread workers' batches bit for bit; from the
    pack both take the native whole-batch path."""
    assert sys.modules.get("jax") is None  # the children fork from a JAX-free process
    specs = _specs(lmdb=layout == "lmdb")
    dataset = _dataset(roots, layout, specs)
    assert (dataset.build_batch([0], [1]) is not None) == (layout == "pack")
    got = {}
    for mode in ("thread", "process"):
        loader = _loader(dataset, specs, mode)
        got[mode] = []
        for epoch in (1, 2):
            loader.set_epoch(epoch)
            got[mode] += list(loader)
    assert len(got["thread"]) == len(got["process"]) == 4
    for a, b in zip(got["thread"], got["process"]):
        assert set(a) == set(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert got["thread"][0]["image"].shape == (3, HW, HW, 3)


class _Faulty:
    """A dataset whose item ``bad`` raises, or kills its own process."""

    def __init__(self, dataset, bad: int, kill: bool):
        self.dataset, self.bad, self.kill = dataset, bad, kill

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, idx, seed=None):
        if idx == self.bad:
            if self.kill:
                os.kill(os.getpid(), signal.SIGKILL)
            raise ValueError(f"item {idx} is unreadable")
        return self.dataset.__getitem__(idx, seed=seed)


@jax_free
def test_worker_exception_raised_in_parent(roots):
    """An item that raises in a forked worker raises the same exception in
    the parent, with the worker's traceback attached."""
    specs = _specs(lmdb=True)
    loader = _loader(_Faulty(_dataset(roots, "lmdb", specs), bad=5, kill=False), specs,
                     "process")
    loader.set_epoch(1)
    with pytest.raises(ValueError, match="item 5 is unreadable") as info:
        list(loader)
    assert any("loader worker" in note for note in info.value.__notes__)


@jax_free
def test_killed_worker_raises_in_parent(roots):
    """A worker killed by a signal ends the epoch with LoaderWorkerDied
    (its sentinel wakes the parent's wait), not a wait without end."""
    specs = _specs(lmdb=True)
    loader = _loader(_Faulty(_dataset(roots, "lmdb", specs), bad=5, kill=True), specs,
                     "process")
    loader.set_epoch(1)
    with pytest.raises(LoaderWorkerDied, match="exit code -9"):
        list(loader)


SPEC = {
    "ModelType": "1encoder2decoder", "Backbone": "resnet18", "ImageSize": [HW, HW],
    "SdfScaleFactor": 7.018621123357809, "LatentSize": 16, "PointFeatSize": 9,
    "EncodeStyle": "both", "PoseFeatSize": 15, "ManoBranch": True, "ObjectPoseBranch": True,
    "ObjCornerWeight": 0.2, "SamplesPerScene": 128, "ScenesPerBatch": 4,
    "DataLoaderThreads": 2, "TrainSplit": "", "LogFrequency": 1, "LogFrequencyStep": 1,
    "NumEpochs": 1, "LMDB": True,
    "NetworkSpecs": {"dims": [32, 32], "dropout": [0, 1], "dropout_prob": 0.2,
                     "norm_layers": [0, 1], "latent_in": [1], "weight_norm": True},
}


@pytest.mark.parametrize("source", ["--data_root", "--packed"])
@jax_free
def test_train_cli_loader_modes_give_the_same_losses(roots, tmp_path, source):
    """cli.train for one epoch of 2 steps, from the LMDBs and from the pack,
    with thread workers and with --loader_mode process: the same losses to
    the last bit (the same batches, the same seeded steps)."""
    path = str(tmp_path / "spec.json")
    with open(path, "w") as f:
        json.dump(SPEC, f)
    data = roots["lmdb"] if source == "--data_root" else roots["pack"]
    losses = {}
    for mode in ("thread", "process"):
        out = str(tmp_path / mode)
        train_cli.main(["-e", path, source, data, "--loader_mode", mode, "--device", "cpu",
                        "--output_root", out, "--no_init_guard", "--skip_test"])
        with open(os.path.join(out, load_specs(path).experiment_name(), "metrics.jsonl")) as f:
            losses[mode] = [ln for ln in map(json.loads, f) if "step" in ln]
    assert len(losses["thread"]) == 2 and losses["thread"] == losses["process"]


def test_loader_mode_needs_a_dataset(tmp_path):
    """--loader_mode without --data_root or --packed is refused: the
    synthetic batches have no loader."""
    path = str(tmp_path / "spec.json")
    with open(path, "w") as f:
        json.dump(SPEC, f)
    with open(os.devnull, "w") as null, contextlib.redirect_stderr(null), \
            pytest.raises(SystemExit):
        train_cli.main(["-e", path, "--loader_mode", "process", "--smoke", "--device", "cpu"])
