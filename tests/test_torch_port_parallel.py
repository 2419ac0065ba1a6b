"""The port's data-parallel plan over gloo ranks on the CPU, the counterpart
of ``tests/test_parallel.py`` (the JAX package's ``shard_map`` plan on an
8-device CPU mesh): training runs and learns, the collective occupancy
update equals the single one, one data-parallel step equals the JAX
package's emulation of its ``pmean`` step, the divisibility guards,
``train_chunk`` against the step loop, and training with the hash tap dedup.

The ranks' work runs once for the module, on two ranks started by the
port's ``tools/dp_check.py`` (one torch thread each, a ``file://``
rendezvous in a fresh temporary directory) while the JAX side computes its
references; 32^3 occupancy grids stand in for the models' 128^3 (a CPU grid
update of 2M cells takes seconds)."""

import copy
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import instant_nsr_pl_tpu.datasets  # noqa: F401  (register)
import instant_nsr_pl_tpu.systems  # noqa: F401  (register)
from instant_nsr_pl_tpu import registry as j_reg
from instant_nsr_pl_tpu.config import config_from_dict as j_config
from instant_nsr_pl_tpu.datasets.synthetic import scene_sdf
from instant_nsr_pl_tpu.ops.marching import OccupancyGridState as JGrid
from instant_nsr_pl_tpu.ops.marching import _postprocess_binary as j_postprocess
from instant_nsr_pl_tpu_torch.models.network_utils import named_leaves
from instant_nsr_pl_tpu_torch.parallel import DataParallelPlan
from instant_nsr_pl_tpu_torch.tools import dp_check
from instant_nsr_pl_tpu_torch.tools.dp_check import build_system
from instant_nsr_pl_tpu_torch.utils.transplant import params_from_jax, port_layout

N_DEV = 2
TIMEOUT = 150  # seconds, the module's ranks
RADIUS = 1.0
GRID_RES = 32


def _cfg():
    """``tests/test_parallel.py``'s hash NeRF (6 levels, 2^15 rows, MLPs 32
    wide), with the JAX fused Pallas head and fast hash gradient the port's
    kernels stand for."""
    mlp = {"otype": "FullyFusedMLP", "activation": "ReLU", "n_neurons": 32}
    return {
        "dataset": {"name": "synthetic", "size": 32, "n_train": 8, "n_val": 1},
        "model": {
            "name": "nerf", "dynamic_ray_sampling": False, "radius": RADIUS,
            "num_samples_per_ray": 64, "train_num_rays": 64, "max_train_num_rays": 256,
            "train_num_samples": 8192, "eval_chunk_rays": 1024, "eval_num_samples": 65536,
            "grid_prune": True, "learned_background": False, "background_color": "random",
            "randomized": True, "batch_image_sampling": True,
            "geometry": {
                "name": "volume-density", "radius": RADIUS, "feature_dim": 16,
                "density_activation": "trunc_exp", "density_bias": -1,
                "isosurface": {"resolution": 32, "chunk": 65536},
                "xyz_encoding_config": {"otype": "HashGrid", "n_levels": 6,
                                        "n_features_per_level": 2, "log2_hashmap_size": 15,
                                        "base_resolution": 16,
                                        "per_level_scale": 1.447269237440378,
                                        "grad_mode": "fast"},
                "mlp_network_config": {**mlp, "output_activation": "none", "n_hidden_layers": 1},
            },
            "texture": {
                "name": "volume-radiance", "input_feature_dim": 16, "fused": True,
                "dir_encoding_config": {"otype": "SphericalHarmonics", "degree": 2},
                "mlp_network_config": {**mlp, "output_activation": "Sigmoid",
                                       "n_hidden_layers": 1},
            },
        },
        "system": {
            "name": "nerf-system", "loss": {"lambda_rgb": 1.0, "lambda_distortion": 0.0},
            "optimizer": {"name": "AdamW",
                          "args": {"lr": 0.01, "betas": [0.9, 0.99], "eps": 1.0e-15}},
            "scheduler": None,
        },
    }


def _parity_cfg():
    """The gradient-parity step: 48 rays (24 a rank), 16,384 samples (8,192
    a rank), 1,024 samples a ray, no stratified jitter (the batches carry
    their backgrounds)."""
    cfg = _cfg()
    cfg["model"].update({"num_samples_per_ray": 1024, "train_num_rays": 48,
                         "max_train_num_rays": 48, "train_num_samples": 16384,
                         "randomized": False})
    return cfg


def _chunk_cfg():
    cfg = _cfg()
    cfg["model"].update({"grid_warmup_steps": 8, "grid_update_every": 4})
    return cfg


def _dedup_cfg():
    """``test_dp_training_with_hash_tap_dedup``'s: 1,024 samples a ray (the
    strided march picks k = 8), 16,384 samples (8,192 a rank)."""
    cfg = _cfg()
    cfg["model"].update({"num_samples_per_ray": 1024, "train_num_samples": 16384})
    return cfg


def _small_grid_cfg():
    """No grid update in the first step (warmup from step 8, every 8)."""
    cfg = _cfg()
    cfg["model"].update({"grid_warmup_steps": 0, "grid_update_every": 8, "grid_prune": False})
    return cfg


def _render_cfg():
    """Eval chunks of 256 rays (1,024 a 32x32 view) with 2,048 samples: a
    chunk overflows, so the render retries rays, collectively."""
    cfg = _cfg()
    cfg["model"].update({"eval_chunk_rays": 256, "eval_num_samples": 2048})
    return cfg


def _grid_cfg():
    """A density bias that leaves part of the 32^3 grid below the threshold,
    so the binary field the test compares is not all occupied."""
    cfg = _cfg()
    cfg["model"]["geometry"]["density_bias"] = -6
    return cfg


def _jax_tree(tree, key=""):
    """A port parameter tree as the JAX package's pytree (numpy; same keys,
    the hash table transposed to its (F, T) layout)."""
    if isinstance(tree, dict):
        return {k: _jax_tree(v, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_jax_tree(v) for v in tree]
    a = tree.detach().numpy().copy()
    return np.ascontiguousarray(a.T) if key == "table" else a


def _inputs():
    """Parameters drawn by the port's init (JAX's eager init compiles every
    op: seconds) with biases moved by 0.05 N(0, 1) and a table of order 1,
    a grid occupied where the scene SDF is below one cell diagonal, and each
    rank's batch (rays from one eye, random colours and backgrounds); all
    numpy, the parameters in the JAX package's layout."""
    from instant_nsr_pl_tpu_torch import registry as t_reg
    from instant_nsr_pl_tpu_torch.config import config_from_dict as t_config
    from instant_nsr_pl_tpu_torch.ops.marching import _dilate_binary

    cfg = _parity_cfg()
    model = t_reg.models.make("nerf", t_config(copy.deepcopy(cfg))["model"])
    params = _jax_tree(model.init(torch.Generator().manual_seed(0), "cpu"))
    rs = np.random.RandomState(0)
    params = jax.tree_util.tree_map(
        lambda a: a + 0.05 * rs.randn(*a.shape).astype(np.float32) if a.ndim == 1 else a,
        params)
    table = params["geometry"]["encoding"]["table"]
    params["geometry"]["encoding"]["table"] = (rs.rand(*table.shape).astype(np.float32)
                                               - 0.5) * 2.0
    res = model.occ_spec.resolution
    c = (np.arange(res, dtype=np.float32) + 0.5) / res * 2 * RADIUS - RADIUS
    z, y, x = np.meshgrid(c, c, c, indexing="ij")  # flattened x-fastest
    binary = scene_sdf(np.stack([x, y, z], -1).reshape(-1, 3)) < np.sqrt(3.0) * 2 * RADIUS / res
    grid = (binary.astype(np.float32), binary,
            _dilate_binary(torch.from_numpy(binary), res).numpy())
    n = cfg["model"]["max_train_num_rays"] // N_DEV
    batches = []
    for r in range(N_DEV):
        rs = np.random.RandomState(10 + r)
        eye = np.array([0.3, -2.4, 0.8], np.float32) * (0.8 + 0.1 * r)
        d = -eye / np.linalg.norm(eye) + rs.randn(n, 3).astype(np.float32) * 0.2
        batches.append({
            "rays_o": np.broadcast_to(eye, (n, 3)).copy(),
            "rays_d": (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32),
            "rgb": rs.rand(n, 3).astype(np.float32),
            "fg_mask": np.ones(n, np.float32),
            "background_color": rs.rand(n, 3).astype(np.float32),
        })
    return cfg, params, grid, batches


@pytest.fixture(scope="module")
def ranks():
    """The ranks' results (rank order) and the JAX reference of the parity
    step, computed while the ranks work."""
    cfg, params, grid, batches = _inputs()
    port_params = {k: v.numpy() for k, v in params_from_jax(params).items()}
    jobs = [
        ("learn", "train_run", (_cfg(), 20, None, 0, GRID_RES)),
        ("grid", "grid_updates", (_grid_cfg(), GRID_RES)),
        ("loop", "train_run", (_chunk_cfg(), 12, None, 0, GRID_RES)),
        ("chunks", "train_run", (_chunk_cfg(), 12, [3, 9], 0, GRID_RES)),
        ("dedup", "train_run", (_dedup_cfg(), 20, None, 0, GRID_RES)),
        ("parity", "step_on_batches", (cfg, port_params, grid, batches)),
        ("render", "render_views", (_render_cfg(), 10, GRID_RES)),
        ("replicate", "replicate_check", (_small_grid_cfg(),)),
    ]
    handle = dp_check.start(dp_check.run_all, N_DEV, jobs, timeout=TIMEOUT)
    ref = _jax_emulation(cfg, params, grid, batches)
    out = {"ranks": handle.result(), "ref": ref}
    print(f"rank jobs (s): {out['ranks'][0]['seconds']}")
    return out


def _jax_emulation(cfg, params, grid, batches):
    """The JAX package's emulation of one ``pmean`` step
    (``test_dp_gradient_parity_matches_single_device``): the mean of
    ``jax.value_and_grad(system.loss_fn)`` over the ranks' batches at
    ``capacity_per_dev``, then ``system.tx``. The JAX radiance head runs its
    XLA path (``fused: false``): its gradients agree with the fused Pallas
    head's in interpret mode within 6e-3 of their largest value here, and it
    compiles in a third of the time."""
    cfg = copy.deepcopy(cfg)
    cfg["model"]["texture"]["fused"] = False
    j_sys = j_reg.systems.make("nerf-system", j_config(cfg))
    j_sys.init_state(seed=0)  # builds system.tx
    binary = jnp.asarray(grid[1])
    dil, bricks = jax.jit(lambda b: j_postprocess(b, j_sys.model.occ_spec))(binary)
    assert (np.asarray(dil) == grid[2]).all()
    grid = JGrid(occs=jnp.asarray(grid[0]), binary=binary, binary_dilated=dil, bricks=bricks)
    params = jax.tree_util.tree_map(jnp.asarray, params)
    n = cfg["model"]["max_train_num_rays"] // N_DEV
    cap = cfg["model"]["train_num_samples"] // N_DEV
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p, b: j_sys.loss_fn(p, {"grid": grid}, b, None, jnp.int32(0), n_rays=n,
                                   capacity=cap), has_aux=True))
    total, losses, samples = None, [], 0
    for b in batches:
        (loss, metrics), grads = grad_fn(params, jax.tree_util.tree_map(jnp.asarray, b))
        losses.append(float(loss))
        samples += int(metrics["train/num_samples"])
        total = grads if total is None else jax.tree_util.tree_map(jnp.add, total, grads)
    mean = jax.tree_util.tree_map(lambda g: g / N_DEV, total)
    # one compiled update (eager optax compiles each op of every leaf: ~9 s)
    after = jax.jit(lambda g, p: optax.apply_updates(p, j_sys.tx.update(g, j_sys.tx.init(p),
                                                                        p)[0]))(mean, params)
    as_np = lambda tree: dict(named_leaves(jax.tree_util.tree_map(np.asarray, tree)))  # noqa: E731
    return {"loss": float(np.mean(losses)), "num_samples": samples, "grads": as_np(mean),
            "params": as_np(after)}


def test_dp_training_runs_and_learns(ranks):
    """20 plan steps over two ranks: finite losses, the mean loss of the
    last five steps below the first five's, the training PSNR above, the
    ranks' states equal to the bit, and the ranks' batches (the plan's own
    draws) different at every step."""
    r0, r1 = (r["learn"] for r in ranks["ranks"])
    losses, psnrs = np.asarray(r0["losses"]), np.asarray(r0["psnrs"])
    assert np.isfinite(losses).all() and r0["step"] == 20
    assert len(r0["batches"]) == len(r1["batches"]) == 20
    assert all(a != b for a, b in zip(r0["batches"], r1["batches"]))
    assert losses[-5:].mean() < losses[:5].mean()
    assert psnrs[-5:].mean() > psnrs[:5].mean()
    assert r0["losses"] == r1["losses"] and r0["digests"] == r1["digests"]


def test_dp_grid_update_collective_matches_single(ranks):
    """The collective occupancy update (evaluations sharded over the ranks
    and gathered) against the single update from the same draws, in the
    warmup, slab and random modes: occupancies within the JAX test's rtol
    1e-5 / atol 1e-6 (equal to the bit here), the binary and dilated fields
    equal, on both ranks."""
    for r in ranks["ranks"]:
        for mode, (single, coll) in r["grid"].items():
            np.testing.assert_allclose(coll[0], single[0], rtol=1e-5, atol=1e-6, err_msg=mode)
            assert (coll[1] == single[1]).all() and (coll[2] == single[2]).all(), mode
            assert 0 < single[1].mean() < 1, mode  # some cells in, some out
    g0, g1 = (r["grid"]["random"][1] for r in ranks["ranks"])
    assert all(np.array_equal(a, b) for a, b in zip(g0, g1))


def test_dp_gradient_parity_matches_jax_emulation(ranks):
    """One data-parallel step over two ranks, each fed its given batch, from
    transplanted JAX parameters and an SDF grid, against the JAX package's
    emulation of its pmean step, at the tolerances of the port's step-parity
    test (``test_hash_nerf_chunk_and_training_step_match_jax``): the loss
    within 1e-3 relative, every averaged gradient within 2.5e-2 of its
    largest reference value; the live-sample count summed exactly. After
    AdamW the parameters equal the JAX package's within 1e-6 wherever the
    reference gradient exceeds that tolerance (both gradients then share
    their sign, which sets the first update) and within 2 lr elsewhere."""
    ref = ranks["ref"]
    r0, r1 = (r["parity"] for r in ranks["ranks"])
    assert r0["metrics"]["train/loss"] == pytest.approx(ref["loss"], rel=1e-3)
    assert int(r0["metrics"]["train/num_samples"]) == ref["num_samples"] > 20 * 48
    lr = 0.01
    for key, got in r0["grads"].items():
        g_ref = port_layout(key, ref["grads"][key])
        tol = 2.5e-2 * max(np.abs(g_ref).max(), 1e-8)
        np.testing.assert_allclose(got, g_ref, rtol=0, atol=tol, err_msg=key)
        assert np.abs(got).max() > 0, key
        p_ref = port_layout(key, ref["params"][key])
        p_got = r0["params"][key]
        sure = np.abs(g_ref) > tol
        assert sure.any(), key
        np.testing.assert_allclose(p_got[sure], p_ref[sure], rtol=0, atol=1e-6, err_msg=key)
        assert np.abs(p_got - p_ref).max() <= 2 * lr + 1e-6, key
        np.testing.assert_array_equal(r1["params"][key], p_got)  # the ranks agree


def test_dp_sharded_render_matches_single(ranks):
    """A val view rendered with each chunk's rays interleaved over the ranks
    (each rank at min(cap, 2 cap / n) samples) and gathered, against the
    same state rendered by one process: the same images within 1e-6 (the
    float64 prefix sums run over other rays), the same on both ranks, with
    overflowed rays retried (the retry decision taken by a collective)."""
    r0, r1 = (r["render"] for r in ranks["ranks"])
    assert r0["stats"]["first_pass_overflow"] > 0
    assert r0["stats"]["rays_kept"] == r0["stats"]["rays"] == 1024
    for k, ref in r0["single"].items():
        np.testing.assert_allclose(r0["sharded"][k], ref, rtol=0, atol=1e-6, err_msg=k)
        np.testing.assert_array_equal(r1["sharded"][k], r0["sharded"][k])
    assert 0.01 < float(r0["single"]["opacity"].mean()) < 0.99


def test_dp_replicate_broadcasts_rank0(ranks):
    """``replicate`` (the broadcast DDP makes when it is built) changes
    nothing where every rank was seeded alike, and makes every rank's
    parameters, AdamW moments and generator rank 0's where they differ."""
    r0, r1 = (r["replicate"] for r in ranks["ranks"])
    assert r0["seeded"] == r1["seeded"] == r0["alike"] == r1["alike"]
    assert r0["moved"] != r1["moved"]
    for key in ("params", "moments", "generator"):
        assert r0["moved"][key] != r1["moved"][key]
    assert r1["replicated"] == r0["replicated"] == r0["moved"]


def test_dp_divisibility_guards():
    """Every ray bucket and the train capacity must divide by the world
    size, and the eval chunk (sharded by the render) too."""
    cfg = _cfg()
    cfg["model"]["max_train_num_rays"] = 100  # not divisible by 8
    system = build_system(cfg, "cpu")
    with pytest.raises(ValueError, match="ray bucket"):
        DataParallelPlan(system, types.SimpleNamespace(size=8, rank=0))
    cfg = _cfg()
    cfg["model"]["train_num_samples"] = 8190
    with pytest.raises(ValueError, match="train capacity"):
        DataParallelPlan(build_system(cfg, "cpu"), types.SimpleNamespace(size=4, rank=0))
    cfg = _cfg()
    cfg["model"]["eval_chunk_rays"] = 1000
    with pytest.raises(ValueError, match="eval_chunk_rays"):
        build_system(cfg, "cpu").configure_parallel(types.SimpleNamespace(size=16, rank=0))
    plan = DataParallelPlan(build_system(_cfg(), "cpu"), types.SimpleNamespace(size=8, rank=3))
    assert (plan.rays_per_dev, plan.capacity_per_dev) == (32, 1024)


def test_dp_train_chunk_matches_per_step_loop(ranks):
    """``train_chunk`` (3 then 9 steps, grid updates every 4 with warmup to
    8) against 12 plan steps: the same cadence, the same last loss and the
    same state to the bit (the port's chunk is the step loop, where the
    JAX package's is a compiled scan)."""
    for r in ranks["ranks"]:
        loop, chunks = r["loop"], r["chunks"]
        assert loop["step"] == chunks["step"] == 12
        assert chunks["losses"][-1] == loop["losses"][-1]
        assert chunks["digests"] == loop["digests"]
        assert np.isfinite(loop["losses"]).all()


def test_dp_training_with_hash_tap_dedup(ranks):
    """The tap dedup under the plan: the strided march's k = 8 blocks and
    the per-rank packed capacity (8,192) divisible by them, the dedup spec
    kept by the hash encoding, 20 steps training (the last five's mean loss
    below the first five's)."""
    r0 = ranks["ranks"][0]["dedup"]
    assert r0["dedup"]
    losses = np.asarray(r0["losses"])
    assert np.isfinite(losses).all()
    assert losses[-5:].mean() < losses[:5].mean()


def test_launcher_refuses_what_it_cannot_run(monkeypatch):
    """No quiet fall-back: ``--devices`` above the visible cards raises
    without ``--backend gloo`` (here, with no card, any count on cuda does),
    ``--devices all`` has no meaning on the CPU, and a partial multi-process
    description (flags or ``NSR_*`` variables) raises."""
    from instant_nsr_pl_tpu_torch.launch import main as launch_main
    from instant_nsr_pl_tpu_torch.parallel.distributed import maybe_initialize_distributed

    argv = ["--config", "configs/nerf-synthetic.yaml", "--train"]
    with pytest.raises(ValueError, match="visible card"):
        launch_main(argv + ["--devices", "2"])
    with pytest.raises(ValueError, match="--devices all"):
        launch_main(argv + ["--device", "cpu", "--devices", "all"])
    for k in ("NSR_COORDINATOR", "NSR_NUM_PROCESSES", "NSR_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    assert maybe_initialize_distributed() is False
    with pytest.raises(ValueError, match="coordinator"):
        maybe_initialize_distributed(coordinator="localhost:1", device="cpu")
    monkeypatch.setenv("NSR_NUM_PROCESSES", "2")
    with pytest.raises(ValueError, match="coordinator"):
        maybe_initialize_distributed(device="cpu")
