"""``configs/neus-colmap.yaml`` on a white COLMAP export, port against the
JAX package: the port's shrunk NeuS-with-background trajectory held against
the JAX package's, step by step, from one transplanted state.

On the white export (``tools/make_synthetic_data.py --format colmap``, no
backdrop: every background pixel is white) the port's full-size
``neus-colmap`` run on the card turned the foreground into a white shell over
the whole view (opacity 1.0, an empty mesh). This test asks whether the port
departs from the JAX package on that data: both loaders read one 32x32
export (4 views, read at 16x16), both systems are built from the config
itself with size cuts (4 hash levels of 2^12 rows, 32-wide MLPs, 128 samples
a ray, both occupancy grids 32^3 and held fully occupied), and both take the
same fixed numpy batches of the train split's pixels with AdamW. At every
step the loss, the foreground opacity of a whole view (its mean and its
pixels) and the SDF's range over a 16^3 lattice of the foreground box
agree. In both packages the view's foreground opacity climbs above 0.99
within the first ten steps and falls back below 0.8 by step 19: a shared
transient, not the shell, which this size does not reach.

Run as a script, ``PYTHONPATH=. python tests/test_torch_port_white_colmap.py
STEPS EVERY [--size 32] [--n-train 4] [overrides...]`` trains both packages with their own ``train_step``
(occupancy updates on, randomized samples) from one transplanted state on
the same export and prints, every EVERY steps, each package's view opacity,
SDF range, occupied share of the grid and the vertex count of a 32^3 mesh:
whether either forms the shell at a size the CPU can reach.

Tolerances, as ``test_neus_trajectory_follows_jax`` (tests/test_torch_port_
neus.py) sets them: each step's gradients agree within 2.5e-2 of their
largest value (bf16 operands, sums in other orders), which Adam turns into
parameter differences that grow over the steps; so the loss within 1e-2
relative, every parameter leaf within 0.25 of the distance its JAX twin has
moved, and the view's opacity and the SDF's extremes within 2e-2 (of 1, and
of the SDF's range). A port that departed from the JAX package (a lost
loss term, another background, another update) exceeds them within a few
steps.
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import instant_nsr_pl_tpu.datasets  # noqa: F401  (register)
import instant_nsr_pl_tpu.datasets.colmap as j_colmap
import instant_nsr_pl_tpu.models  # noqa: F401  (register)
import instant_nsr_pl_tpu.systems  # noqa: F401  (register)
import instant_nsr_pl_tpu_torch.datasets  # noqa: F401  (register)
import instant_nsr_pl_tpu_torch.datasets.colmap as t_colmap
import instant_nsr_pl_tpu_torch.systems  # noqa: F401  (register)
from instant_nsr_pl_tpu import registry as j_reg
from instant_nsr_pl_tpu.config import load_config as j_load_config
from instant_nsr_pl_tpu.ops import marching as j_march
from instant_nsr_pl_tpu_torch import registry as t_reg
from instant_nsr_pl_tpu_torch.config import load_config as t_load_config
from instant_nsr_pl_tpu_torch.models.network_utils import make_trainable, named_leaves
from instant_nsr_pl_tpu_torch.ops.ray import get_rays
from instant_nsr_pl_tpu_torch.tools import make_synthetic_data as t_make
from instant_nsr_pl_tpu_torch.utils.transplant import (
    occupancy_from_jax,
    params_from_jax,
    params_from_state_dict,
    port_layout,
)

CONFIG = Path(__file__).resolve().parents[1] / "configs" / "neus-colmap.yaml"
STEPS = 20
N_RAYS = 64
RES = 32  # both occupancy grids, in place of the models' 128^3 / 256^3
HASH_CUTS = ("n_levels=4", "log2_hashmap_size=12")
CUTS = [
    "dataset.img_downscale=2", "dataset.up_est_method=camera", "dataset.n_test_traj_steps=1",
    "model.num_samples_per_ray=128", f"model.train_num_rays={N_RAYS}",
    f"model.max_train_num_rays={N_RAYS}", "model.train_num_samples=8192",
    "model.train_num_samples_bg=4096", "model.eval_chunk_rays=256",
    "model.eval_num_samples=32768", "model.eval_num_samples_bg=16384", "model.randomized=false",
    *(f"model.{g}.xyz_encoding_config.{c}" for g in ("geometry", "geometry_bg")
      for c in HASH_CUTS),
    *(f"model.{m}.mlp_network_config.n_neurons=32"
      for m in ("geometry", "texture", "geometry_bg", "texture_bg")),
]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    j_colmap.ColmapDatasetBase._cache = {}
    t_colmap.ColmapDatasetBase._cache = {}
    yield
    torch.set_num_threads(n)
    j_colmap.ColmapDatasetBase._cache = {}
    t_colmap.ColmapDatasetBase._cache = {}


def _full_grid(spec):
    binary = np.ones(spec.resolution ** 3, bool)
    dil, bricks = jax.jit(lambda b: j_march._postprocess_binary(b, spec))(binary)
    return j_march.OccupancyGridState(jnp.ones(binary.shape, jnp.float32), jnp.asarray(binary),
                                      dil, bricks)


def _carry(params):
    return make_trainable(params_from_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)), "cpu"))


def _view_rays(ds, index):
    """A whole view's unit rays, from the dataset's own directions and pose."""
    dirs = torch.from_numpy(np.asarray(ds.directions, np.float32)).reshape(-1, 3)
    o, d = get_rays(dirs, torch.from_numpy(np.asarray(ds.all_c2w[index], np.float32)))
    return o.numpy(), (d / torch.linalg.norm(d, dim=-1, keepdim=True)).numpy()


def _batches(ds, rs, steps):
    """Fixed batches of random train pixels (rays, white-export colours, a
    random background colour per ray), the same numpy arrays for both."""
    rays = [_view_rays(ds, i) for i in range(len(ds.all_images))]
    images = np.asarray(ds.all_images, np.float32).reshape(len(rays), -1, 3)
    out = []
    for _ in range(steps):
        img = rs.randint(0, len(rays), N_RAYS)
        pix = rs.randint(0, images.shape[1], N_RAYS)
        out.append({
            "rays_o": np.stack([rays[i][0][p] for i, p in zip(img, pix)]),
            "rays_d": np.stack([rays[i][1][p] for i, p in zip(img, pix)]),
            "rgb": images[img, pix],
            "fg_mask": np.ones(N_RAYS, np.float32),
            "background_color": rs.rand(N_RAYS, 3).astype(np.float32),
        })
    return out


def test_white_colmap_neus_trajectory_follows_jax(tmp_path):
    """``neus-colmap.yaml`` (size cuts only) on the white export: both
    loaders read the same views and poses; then STEPS steps of
    ``NeuSSystem.loss_fn`` + AdamW from one transplanted state in both
    packages, the loss, every parameter leaf, a whole view's foreground
    opacity and the SDF's range over the box held together at every step."""
    import optax

    from instant_nsr_pl_tpu.systems.optimizers import make_optimizer as j_make_optimizer
    from instant_nsr_pl_tpu_torch.systems.optimizers import make_optimizer as t_make_optimizer

    assert t_make.main(["--out", str(tmp_path), "--format", "colmap", "--size", "32",
                        "--n-train", "4"]) == 0
    cuts = [f"dataset.root_dir={tmp_path / 'colmap'}", *CUTS]
    j_cfg, t_cfg = j_load_config(str(CONFIG), list(cuts)), t_load_config(str(CONFIG), list(cuts))
    j_dm = j_reg.datasets.make("colmap", j_cfg.dataset)
    t_dm = t_reg.datasets.make("colmap", t_cfg.dataset)
    j_dm.setup("fit")
    t_dm.setup("fit")
    j_ds, t_ds = j_dm.train, t_dm.train
    np.testing.assert_array_equal(t_ds.all_images, j_ds.all_images)
    np.testing.assert_allclose(t_ds.all_c2w, j_ds.all_c2w, rtol=0, atol=1e-6)
    assert t_ds.all_images.shape == (4, 16, 16, 3)
    # the white export: every background pixel is white
    assert (t_ds.all_images.reshape(-1, 3).min(-1) == 1.0).mean() > 0.3

    j_sys = j_reg.systems.make("neus-system", j_cfg)
    t_sys = t_reg.systems.make("neus-system", t_cfg, device="cpu")
    for s in (j_sys, t_sys):
        s.has_mask = False
        for attr in ("occ_spec", "occ_spec_bg"):
            setattr(s.model, attr, dataclasses.replace(getattr(s.model, attr), resolution=RES))
    j_occ = {"grid": _full_grid(j_sys.model.occ_spec),
             "grid_bg": _full_grid(j_sys.model.occ_spec_bg)}
    t_occ = {k: occupancy_from_jax(v, "cpu") for k, v in j_occ.items()}

    j_params = jax.tree_util.tree_map(np.asarray,
                                      jax.jit(j_sys.model.init)(jax.random.PRNGKey(0)))
    tx, _ = j_make_optimizer(j_cfg.system.optimizer, None, j_params)

    @jax.jit
    def j_step(p, opt_state, batch, step):
        (loss, metrics), g = jax.value_and_grad(
            lambda p: j_sys.loss_fn(p, j_occ, batch, None, step), has_aux=True)(p)
        updates, opt_state = tx.update(g, opt_state, p)
        return optax.apply_updates(p, updates), opt_state, loss

    # a whole view on white, as validation renders it, and the SDF over the box
    vo, vd = _view_rays(t_ds, 1)
    r = float(t_cfg.model.radius)
    c = (np.arange(16, dtype=np.float32) + 0.5) / 16 * 2 * r - r
    pts = np.stack(np.meshgrid(c, c, c, indexing="ij"), -1).reshape(-1, 3)

    @jax.jit
    def j_probe(p, step):
        out = j_sys.forward_eval(p, j_occ, jnp.asarray(vo), jnp.asarray(vd), jnp.ones(3), step)
        return out["opacity"], j_sys.model.forward_level(p, jnp.asarray(pts))

    def t_probe(p, step):
        with torch.no_grad():
            out = t_sys.forward_eval(p, t_occ, torch.from_numpy(vo), torch.from_numpy(vd),
                                     torch.ones(3), step=step)
            return out["opacity"].numpy(), t_sys.model.forward_level(
                p, torch.from_numpy(pts)).numpy()

    params = _carry(j_params)
    opt, _ = t_make_optimizer(t_cfg.system.optimizer, None, params)
    start = {key: t.detach().clone() for key, t in named_leaves(params)}
    jp, j_opt = j_params, tx.init(j_params)
    trace = []
    for k, batch in enumerate(_batches(t_ds, np.random.RandomState(11), STEPS)):
        jp, j_opt, j_loss = j_step(jp, j_opt, jax.tree_util.tree_map(jnp.asarray, batch),
                                   jnp.int32(k))
        opt.zero_grad()
        loss, _ = t_sys.loss_fn(params, t_occ, {kk: torch.from_numpy(v) for kk, v in
                                                 batch.items()}, None, k)
        loss.backward()
        opt.step(k)
        assert float(loss.detach()) == pytest.approx(float(j_loss), rel=1e-2), k
        ref = dict(named_leaves(jax.tree_util.tree_map(np.asarray, jp)))
        for key, t in named_leaves(params):
            rt = torch.from_numpy(np.array(port_layout(key, ref[key]), np.float32))
            moved = float((rt - start[key]).norm())
            assert float((t.detach() - rt).norm()) <= 0.25 * moved + 1e-6, (k, key)
        j_opac, j_sdf = (np.asarray(a) for a in j_probe(jp, jnp.int32(k + 1)))
        t_opac, t_sdf = t_probe(params, k + 1)
        assert np.abs(t_opac - j_opac).max() <= 2e-2, (k, np.abs(t_opac - j_opac).max())
        span = float(j_sdf.max() - j_sdf.min())
        assert abs(float(t_sdf.min()) - float(j_sdf.min())) <= 2e-2 * span, k
        assert abs(float(t_sdf.max()) - float(j_sdf.max())) <= 2e-2 * span, k
        trace.append((float(loss.detach()), float(j_loss), float(t_opac.mean()),
                      float(j_opac.mean()), float(t_sdf.min()), float(j_sdf.min()),
                      float(t_sdf.max()), float(j_sdf.max())))
    print("step loss (port, JAX), view opacity (port, JAX), sdf min, sdf max")
    for k, row in enumerate(trace):
        print(k, " ".join(f"{v:.5f}" for v in row))
    # in both packages the foreground first covers the whole white view, then
    # recedes: the same transient, no shell at this size
    for col in (2, 3):
        assert max(row[col] for row in trace) > 0.99 and trace[-1][col] < 0.8


def own_training(root, steps, every, overrides=(), size=32, n_train=4, log=print):
    """Both packages' own ``train_step`` (occupancy updates on, randomized
    samples) from one transplanted state on one white export written under
    ``root``; logs, every ``every`` steps and at the end, each package's
    whole-view foreground opacity, SDF range over the box, occupied share of
    the foreground grid and vertex count of a 32^3 mesh."""
    assert t_make.main(["--out", str(root), "--format", "colmap", "--size", str(size),
                        "--n-train", str(n_train)]) == 0
    cuts = [f"dataset.root_dir={Path(root) / 'colmap'}", *CUTS, "model.randomized=true",
            "model.geometry.isosurface.resolution=32", *overrides]
    j_cfg, t_cfg = j_load_config(str(CONFIG), list(cuts)), t_load_config(str(CONFIG), list(cuts))
    j_dm = j_reg.datasets.make("colmap", j_cfg.dataset)
    t_dm = t_reg.datasets.make("colmap", t_cfg.dataset)
    j_dm.setup("fit")
    t_dm.setup("fit")
    j_sys = j_reg.systems.make("neus-system", j_cfg)
    t_sys = t_reg.systems.make("neus-system", t_cfg, device="cpu")
    for s in (j_sys, t_sys):
        for attr in ("occ_spec", "occ_spec_bg"):
            setattr(s.model, attr, dataclasses.replace(getattr(s.model, attr), resolution=RES))
    j_sys.setup_data(j_dm.train)
    t_sys.setup_data(t_dm.train)
    js, ts = j_sys.init_state(0), t_sys.init_state(0)
    carried = dict(named_leaves(params_from_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, js["params"])), "cpu")))
    with torch.no_grad():
        for key, t in named_leaves(ts["params"]):
            t.copy_(carried[key])
    vo, vd = _view_rays(t_dm.train, 1)
    r = float(t_cfg.model.radius)
    c = (np.arange(16, dtype=np.float32) + 0.5) / 16 * 2 * r - r
    pts = np.stack(np.meshgrid(c, c, c, indexing="ij"), -1).reshape(-1, 3)

    def probe(k):
        j_out = j_sys.forward_eval(js["params"], js["occ"], jnp.asarray(vo), jnp.asarray(vd),
                                   jnp.ones(3), k)
        j_sdf = np.asarray(j_sys.model.forward_level(js["params"], jnp.asarray(pts)))
        with torch.no_grad():
            t_out = t_sys.forward_eval(ts["params"], ts["occ"], torch.from_numpy(vo),
                                       torch.from_numpy(vd), torch.ones(3), step=k)
            t_sdf = t_sys.model.forward_level(ts["params"], torch.from_numpy(pts)).numpy()
        for name, out, sdf, occ, mesh in (
                ("JAX", j_out["opacity"], j_sdf, np.asarray(js["occ"]["grid"].binary),
                 j_sys.model.isosurface(js["params"], step=k)),
                ("port", t_out["opacity"].numpy(), t_sdf, ts["occ"]["grid"].binary.numpy(),
                 t_sys.model.isosurface(ts["params"], step=k))):
            log(f"step {k} {name}: view opacity mean {float(np.mean(out)):.4f}, "
                f"sdf [{float(sdf.min()):.4f}, {float(sdf.max()):.4f}], grid occupied "
                f"{float(np.mean(occ)):.4f}, mesh vertices {len(mesh['v_pos'])}")

    for k in range(steps):
        if k % every == 0:
            probe(k)
        js, _ = j_sys.train_step(js)
        ts, _ = t_sys.train_step(ts)
    probe(steps)


if __name__ == "__main__":
    import argparse
    import tempfile

    ap = argparse.ArgumentParser(description="both packages' own training on a white export")
    ap.add_argument("steps", type=int)
    ap.add_argument("every", type=int)
    ap.add_argument("overrides", nargs="*", help="config overrides after the size cuts")
    ap.add_argument("--size", type=int, default=32, help="the export's views, size x size")
    ap.add_argument("--n-train", type=int, default=4)
    args = ap.parse_args()
    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(2)
    with tempfile.TemporaryDirectory() as tmp:
        own_training(tmp, args.steps, args.every, args.overrides, size=args.size,
                     n_train=args.n_train, log=lambda m: print(m, flush=True))
