"""The train CLI's epoch loop over an LMDB dataset on the CPU, at a narrow
width (4 scenes, 2 a batch, trunks of 2 x 32), with the stem pool through
K7's plain version: checkpoints, the metrics JSONL, the LR schedule,
--continue, and the override flags that act only through the dataset and
the epochs."""

import argparse
import json
import os

import numpy as np
import pytest
import torch

from alignsdf_tpu.config import add_train_args as jax_add_train_args
from alignsdf_tpu.config import apply_overrides as jax_apply_overrides
from alignsdf_tpu.config import specs_from_dict as jax_specs_from_dict
from alignsdf_torch.cli import train as train_cli
from alignsdf_torch.config import load_specs
from alignsdf_torch.data.synthetic import write_synthetic_lmdb
from alignsdf_torch.kernels import maxpool
from alignsdf_torch.models import resnet
from alignsdf_torch.training.train_state import learning_rate_for_epoch

import torch_parity

SPEC = dict(torch_parity.FLAGSHIP_NARROW, ImageSize=[64, 64], LatentSize=16,
            SamplesPerScene=128, ScenesPerBatch=2, DataLoaderThreads=2, TrainSplit="",
            LogFrequency=1, LogFrequencyStep=1, SnapshotFrequency=0, AdditionalSnapshots=[1],
            NumEpochs=2, LMDB=True,
            NetworkSpecs=dict(torch_parity.FLAGSHIP_NARROW["NetworkSpecs"], dims=[32, 32],
                              dropout=[0, 1], norm_layers=[0, 1], latent_in=[1]),
            LearningRateSchedule=[{"Type": "Step", "Initial": 1e-4, "Interval": 1,
                                   "Factor": 0.5}])


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with torch_parity.torch_threads(1):
        yield


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    base = write_synthetic_lmdb(str(root), [f"{i:08d}" for i in range(4)], n_points=400,
                                image_hw=64)
    spec = os.path.join(str(root), "spec.json")
    with open(spec, "w") as f:
        json.dump(SPEC, f)
    return base, spec


@pytest.fixture
def pool_calls(monkeypatch):
    """Count the stem's calls of the K7 pool (its plain version on the CPU)
    with the switch on."""
    calls = []
    k7 = maxpool.maxpool_k3s2p1

    def counted(x):
        calls.append(tuple(x.shape))
        return k7(x)

    monkeypatch.setattr(maxpool, "maxpool_k3s2p1", counted)
    monkeypatch.setattr(resnet, "KERNEL_POOL", True)
    return calls


def _run(spec, base, out, *extra):
    """The experiment directory the run made."""
    before = set(os.listdir(out)) if os.path.isdir(out) else set()
    train_cli.main(["-e", spec, "--data_root", base, "--device", "cpu", "--output_root", out,
                    "--no_init_guard", *extra])
    (exp,) = set(os.listdir(out)) - before
    return os.path.join(out, exp)


def _metrics(exp):
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    return [ln for ln in lines if "step" in ln], [ln for ln in lines if "lr" in ln]


def _saved_epoch(exp, name="latest"):
    return torch.load(os.path.join(exp, "ModelParameters", f"{name}.pth"),
                      weights_only=False)["epoch"]


def test_epochs_checkpoints_metrics_and_continue(data, tmp_path, pool_calls, capsys):
    """Two epochs of 2 steps with the stem pool switched to K7: latest.pth
    (LogFrequency 1) and the AdditionalSnapshots' 1.pth, a metrics line per
    step and per epoch with the LR of learning_rate_for_epoch, one K7 call a
    step; then --continue from that directory with --epoch 3 (which renames
    the experiment) resumes at epoch 3 from the saved weights."""
    base, spec = data
    out = str(tmp_path / "out")
    first = _run(spec, base, out)
    steps, epochs = _metrics(first)
    specs = load_specs(spec)
    assert [(s["epoch"], s["step"]) for s in steps] == [(1, 1), (1, 2), (2, 3), (2, 4)]
    assert all(np.isfinite(v) for s in steps for v in s.values())
    assert [e["epoch"] for e in epochs] == [1, 2]
    assert [e["lr"] for e in epochs] == [learning_rate_for_epoch(specs, e) for e in (1, 2)]
    assert [e["lr"] for e in epochs] == [5e-5, 2.5e-5]
    assert _saved_epoch(first) == 2 and _saved_epoch(first, "1") == 1
    assert len(pool_calls) == 4 and pool_calls[0] == (2, 64, 32, 32)

    saved = torch.load(os.path.join(first, "ModelParameters", "latest.pth"),
                       weights_only=False)["model_state_dict"]
    starts = []
    real_step = train_cli.make_trainer

    def spy(*args, **kwargs):
        state, step = real_step(*args, **kwargs)

        def first_step(st, batch, seed, **kw):
            if not starts:
                starts.append({k: v.detach().clone() for k, v in st.model.state_dict().items()})
            return step(st, batch, seed, **kw)

        first_step.decode = step.decode
        return state, first_step

    train_cli.make_trainer = spy
    capsys.readouterr()
    try:
        second = _run(spec, base, out, "--continue", first, "--epoch", "3")
    finally:
        train_cli.make_trainer = real_step
    assert "_e3_" in os.path.basename(second)
    assert f"resumed from latest of {first} at epoch 2" in capsys.readouterr().err
    steps, epochs = _metrics(second)
    assert [e["epoch"] for e in epochs] == [3] and [s["epoch"] for s in steps] == [3, 3]
    assert _saved_epoch(second) == 3
    assert all(torch.equal(starts[0][k], v) for k, v in saved.items())
    assert len(pool_calls) == 6


def _spy_loader(monkeypatch):
    seen = {}
    real = train_cli.make_loader

    def spy(specs, *args, **kwargs):
        seen["specs"] = specs
        seen["loader"] = real(specs, *args, **kwargs)
        return seen["loader"]

    monkeypatch.setattr(train_cli, "make_loader", spy)
    return seen


@pytest.mark.parametrize("flag", [["--no_aug"], ["--bg_aug"], ["--epoch", "2"],
                                  ["--lr_interval", "3"], ["--lr_factor", "0.1"]])
def test_flags_act_with_data_root(data, tmp_path, monkeypatch, flag):
    """With --data_root the five flags the synthetic path refuses act as in
    the JAX package: --no_aug makes the items deterministic (no rotation
    whatever the seed), --epoch sets NumEpochs, --lr_interval and
    --lr_factor set the schedule the logged LR follows, and --bg_aug renames
    the experiment as JAX's config does."""
    base, spec = data
    seen = _spy_loader(monkeypatch)
    out = str(tmp_path / "out")
    epochs_flag = [] if flag[0] == "--epoch" else ["--epoch", "1"]
    exp = _run(spec, base, out, *flag, *epochs_flag)
    specs = seen["specs"]
    _, epochs = _metrics(exp)
    lrs = [e["lr"] for e in epochs]
    parser = argparse.ArgumentParser()
    jax_add_train_args(parser)
    jax_specs = jax_apply_overrides(jax_specs_from_dict(SPEC),
                                    parser.parse_args([*flag, *epochs_flag]))
    assert os.path.basename(exp) == jax_specs.experiment_name()
    if flag[0] == "--no_aug":
        assert specs.disable_aug and "_aug0_" in os.path.basename(exp)
        ds = seen["loader"].dataset
        a, b = ds.__getitem__(0, seed=3), ds.__getitem__(0, seed=4)
        np.testing.assert_array_equal(a["image"], b["image"])
    elif flag[0] == "--bg_aug":
        assert specs.background_aug and "_bg1_" in os.path.basename(exp)
    elif flag[0] == "--epoch":
        assert specs.num_epochs == 2 and [e["epoch"] for e in epochs] == [1, 2]
    elif flag[0] == "--lr_interval":
        assert specs.lr_schedules[0].interval == 3 and lrs == [1e-4]
    else:
        assert specs.lr_schedules[0].factor == 0.1 and lrs == [pytest.approx(1e-5)]


def test_data_root_and_synthetic_flags_exclude_each_other(data, capsys):
    """--smoke / --steps train on synthetic batches and --continue resumes
    the epoch loop: the CLI refuses the mixtures before it trains."""
    base, spec = data
    for argv in (["--data_root", base, "--smoke"], ["--data_root", base, "--steps", "2"],
                 ["--smoke", "--continue", "latest"]):
        with pytest.raises(SystemExit) as exc:
            train_cli.main(["-e", spec, "--device", "cpu", *argv])
        assert exc.value.code == 2
    assert "--continue" in capsys.readouterr().err
