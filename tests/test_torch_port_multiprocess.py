"""The port's data-parallel runs across processes on the CPU (gloo), the
counterpart of ``tests/test_multiprocess.py``: two ranks started one by one
through the ``NSR_*`` variables against ``--devices 2`` of one launcher, and
the NeuS learned-background checkpoint round trip at 2 and 4 ranks.

Each rank runs on one torch thread (``OMP_NUM_THREADS=1``: several pytest
workers share the cores); ranks meet through a ``file://`` rendezvous under
``tmp_path``, so concurrent workers cannot race for a port. Every launch has
its own timeout."""

import csv
import functools
import glob
import os
import subprocess
import sys

import pytest
import torch

from instant_nsr_pl_tpu_torch.launch import main as launch_main
from instant_nsr_pl_tpu_torch.tools import dp_check

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 120  # seconds, each launch

# configs/nerf-synthetic.yaml cut to a CPU run: 4 steps, one grid update
NERF = ["--config", "configs/nerf-synthetic.yaml", "--train", "--device", "cpu",
        "dataset.size=16", "dataset.n_train=2", "dataset.n_val=1", "dataset.n_test=1",
        "model.train_num_rays=64", "model.max_train_num_rays=128",
        "model.train_num_samples=4096", "model.eval_chunk_rays=256",
        "model.eval_num_samples=16384", "model.grid_warmup_steps=0",
        "model.geometry.isosurface.resolution=16", "trainer.max_steps=4",
        "trainer.log_every_n_steps=1", "trainer.val_check_interval=4"]

# the JAX test's NeuS with the learned background (configs/neus-dtu.yaml on
# the synthetic scene), cut alike
NEUS_OVERRIDES = [
    "dataset.name=synthetic", "dataset.size=24", "dataset.n_train=4", "dataset.n_val=1",
    "model.dynamic_ray_sampling=false", "model.train_num_rays=64",
    "model.num_samples_per_ray=32", "model.max_train_num_rays=256",
    "model.train_num_samples=2048", "model.num_samples_per_ray_bg=16",
    "model.train_num_samples_bg=1024", "model.eval_chunk_rays=512",
    "model.eval_num_samples=16384", "model.eval_num_samples_bg=16384",
    "model.cos_anneal_end=50", "model.grid_warmup_steps=1",
    "model.geometry.isosurface.resolution=16",
    "model.geometry.xyz_encoding_config.n_levels=4",
    "model.geometry.xyz_encoding_config.log2_hashmap_size=12",
    "model.geometry.mlp_network_config.n_neurons=16",
    "model.geometry_bg.xyz_encoding_config.n_levels=4",
    "model.geometry_bg.xyz_encoding_config.log2_hashmap_size=12",
    "model.geometry_bg.mlp_network_config.n_neurons=16",
]


def _env():
    env = {k: v for k, v in os.environ.items() if not k.startswith("NSR_")}
    env["OMP_NUM_THREADS"] = "1"
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _run_of(exp):
    (run,) = glob.glob(os.path.join(exp, "*", "*"))
    with open(os.path.join(run, "csv_logs", "metrics.csv")) as fh:
        losses = [float(r["train/loss"]) for r in csv.DictReader(fh) if r.get("train/loss")]
    return torch.load(os.path.join(run, "ckpt", "step=4.ckpt"), weights_only=True), losses


def _equal(a, b, where=""):
    """Two checkpoint payloads equal to the bit."""
    if isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            _equal(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{where}[{i}]")
    elif torch.is_tensor(a):
        assert a.dtype == b.dtype and torch.equal(a, b), where
    else:
        assert a == b, where


def test_nsr_ranks_equal_devices_launch(tmp_path, monkeypatch):
    """Two launcher processes joined through NSR_COORDINATOR /
    NSR_NUM_PROCESSES / NSR_PROCESS_ID train exactly as ``--devices 2`` of
    one launcher: both runs end (each checkpoint is written after the ranks'
    states were found equal to the bit), their step-4 checkpoints are equal
    to the bit and their logged losses are equal. The ``--devices 2`` ranks
    run under ``tools/dp_check.py``'s observer (which the card's smoke
    uses): it leaves the run as it is, the ranks' batches differ at every
    step, and rank 0's emulation of step 2 rebuilds the ranks' batches and
    matches the plan's averaged gradients and update."""
    env = _env()
    procs = []
    for rank in range(2):
        e = dict(env, NSR_COORDINATOR=f"file://{tmp_path / 'rdzv'}", NSR_NUM_PROCESSES="2",
                 NSR_PROCESS_ID=str(rank))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "instant_nsr_pl_tpu_torch.launch", *NERF,
             "--exp_dir", str(tmp_path / "nsr")],
            cwd=ROOT, env=e, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    try:
        for k, v in env.items():
            monkeypatch.setenv(k, v)  # the spawned ranks' environment
        monkeypatch.chdir(ROOT)
        report = str(tmp_path / "observed.json")
        hook = functools.partial(dp_check.observe, out=report, emulate_at=2, warm_from=1)
        assert launch_main([*NERF, "--devices", "2", "--exp_dir",
                            str(tmp_path / "devices")], rank_hook=hook) == 0
        for p in procs:
            out, _ = p.communicate(timeout=TIMEOUT)
            assert p.returncode == 0, out[-4000:]
    finally:
        for p in procs:
            p.kill()
    ckpt_nsr, losses_nsr = _run_of(str(tmp_path / "nsr"))
    ckpt_dev, losses_dev = _run_of(str(tmp_path / "devices"))
    assert len(losses_dev) == 4 and losses_nsr == losses_dev
    _equal(ckpt_nsr, ckpt_dev)
    assert ckpt_dev["step"] == 4
    records = dp_check.read_report(report)
    assert [len(r["steps"]) for r in records] == [4, 4]
    assert dp_check.same_batches(records) == []
    assert dp_check.agree(records, "digests_end")
    emu = records[0]["emulation"]
    assert emu["step"] == 2 and dp_check.emulation_batches_match(records)
    assert emu["grad_share"] <= emu["rel"] and emu["update_share"] <= emu["rel"]


@pytest.mark.parametrize("nproc", [2, 4], ids=["2proc", "4proc"])
def test_multi_process_neus_bg_checkpoint_roundtrip(tmp_path, nproc):
    """NeuS with the learned background over ``nproc`` gloo ranks (32^3
    grids in place of 128^3 / 256^3): two steps, rank 0 saves, two more (the
    uninterrupted arm); every rank restores rank 0's file into a fresh state
    and runs the same two steps: losses and the full state (parameters,
    moments, both grids, extra state, generator) equal to the bit, on every
    rank alike."""
    rs = dp_check.spawn(dp_check.checkpoint_roundtrip, nproc,
                        os.path.join(ROOT, "configs", "neus-dtu.yaml"), NEUS_OVERRIDES,
                        str(tmp_path / "exp"), 2, 32, timeout=TIMEOUT)
    r0 = rs[0]
    assert r0["has_bg"]
    for r in rs:
        assert r["losses_res"] == r["losses_cont"]
        assert r["res"] == r["cont"]
        assert r["cont"] == r0["cont"] and r["losses_cont"] == r0["losses_cont"]
    assert r0["cont"]["step"] == 4
