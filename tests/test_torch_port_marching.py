"""Marching tetrahedra and mesh output of the port against the JAX package:
the port's dispatch (``ops/isosurface.py`` ``marching_tetrahedra``: numpy
arrays and CPU tensors go to the numpy twin, the plain version of MT1 / MT2,
whose card tests are in ``test_torch_port_cuda.py``) against JAX
``marching_tetrahedra`` on small fields (19^3 to 32^3) to the bit; a plain
emulation of the kernels' design (``tools/mt_bench.py``: the per-line
classification, the tile scan, the weld by edge rank) against it too; the
two-stage extraction with its level grid kept as a tensor on the model's
device against the JAX package's extraction; and the OBJ writer
(``utils/savers.py`` ``save_obj``, formatted in ``obj_writer.cc``) byte for
byte against the JAX package's, with and without vertex colours."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instant_nsr_pl_tpu.config import config_from_dict as j_config
from instant_nsr_pl_tpu.models.isosurface import extract_isosurface as j_extract
from instant_nsr_pl_tpu.ops.isosurface import marching_tetrahedra as j_marching
from instant_nsr_pl_tpu.utils.savers import save_obj as j_save_obj
from instant_nsr_pl_tpu_torch.config import config_from_dict as t_config
from instant_nsr_pl_tpu_torch.models import isosurface as t_iso_model
from instant_nsr_pl_tpu_torch.ops import isosurface as t_iso
from instant_nsr_pl_tpu_torch.tools import mt_bench
from instant_nsr_pl_tpu_torch.utils.savers import save_obj as t_save_obj


def _sphere(res, radius=0.6, center=(0.05, -0.1, 0.02)):
    c = np.linspace(-1.0, 1.0, res, dtype=np.float32)
    x, y, z = np.meshgrid(c, c, c, indexing="ij")
    return (np.sqrt((x - center[0]) ** 2 + (y - center[1]) ** 2 + (z - center[2]) ** 2)
            - radius).astype(np.float32)


def _nan_field():
    """A sphere SDF with NaN corners: the four cubes around one crossed +z
    edge each get a NaN corner off the edge (the edge is crossed only inside
    NaN cubes, so it gives no vertex), and a dozen scattered NaNs. Returns the
    field and that edge's lower end."""
    v = _sphere(30)
    inside = v < 0
    xs, ys, zs = np.nonzero(inside[:, :, :-1] != inside[:, :, 1:])
    pick = [(x, y, z) for x, y, z in zip(xs, ys, zs) if 2 <= x <= 27 and 2 <= y <= 27]
    x, y, z = pick[len(pick) // 3]
    for dx in (-1, 1):
        for dy in (-1, 1):
            v[x + dx, y + dy, z] = np.nan
    v[tuple(np.random.RandomState(5).randint(0, 30, (12, 3)).T)] = np.nan
    return v, (x, y, z)


def _box_field():
    """A sphere of radius 1.2 about the centre of [-1, 1]^3 on a 21 x 19 x 23
    grid: the surface cuts all six faces of the box, so mesh edges start on
    the far faces, where no cube has its origin."""
    axes = [np.linspace(-1.0, 1.0, n, dtype=np.float32) for n in (21, 19, 23)]
    x, y, z = np.meshgrid(*axes, indexing="ij")
    return (np.sqrt(x ** 2 + y ** 2 + z ** 2) - 1.2).astype(np.float32)


FIELDS = {
    "sphere": lambda: (_sphere(32), 0.0),
    "random": lambda: (np.random.RandomState(0).randn(24, 27, 30).astype(np.float32), 0.1),
    "density": lambda: (-np.exp(4.0 * -np.abs(_sphere(28))).astype(np.float32) * 10.0, -5.0),
    "ties": lambda: ((np.round(_sphere(24) * 8) / 8).astype(np.float32), 0.0),
    "nan": lambda: (_nan_field()[0], 0.0),
    "box": lambda: (_box_field(), 0.0),
}


@pytest.mark.parametrize("field", sorted(FIELDS))
def test_marching_twin_and_dispatch_match_jax(field):
    """The numpy twin, reached through the dispatch with a numpy array (numpy
    out) and with a CPU tensor (tensors out), against JAX
    ``marching_tetrahedra``: equal vertices and faces; no kernel runs."""
    values, iso = FIELDS[field]()
    jv, jf = j_marching(values, iso)
    before = t_iso.marching_classify.launches, t_iso.marching_emit.launches
    nv, nf = t_iso.marching_tetrahedra(values, iso)
    tv, tf = t_iso.marching_tetrahedra(torch.from_numpy(values), iso)
    assert (t_iso.marching_classify.launches, t_iso.marching_emit.launches) == before
    assert isinstance(nv, np.ndarray) and torch.is_tensor(tv) and len(jf) > 100
    for v, f in ((nv, nf), (tv.numpy(), tf.numpy())):
        assert v.dtype == np.float32 and f.dtype == np.int64
        np.testing.assert_array_equal(v, jv)
        np.testing.assert_array_equal(f, jf)


@pytest.mark.parametrize("field", sorted(FIELDS))
def test_marching_design_emulation_matches_jax(field):
    """The kernels' design emulated in numpy (``tools/mt_bench.py``: MT1's
    byte per grid vertex, per-line counts and chunk masks, the tile scan,
    MT2's walk of each line over its marked chunks of 128 z, 4 z a lane, with
    the running vertex counts of four lines, vertex ids from the edge rank)
    against JAX ``marching_tetrahedra``: the
    same vertices and faces to the bit, in the same order; the scanned totals
    are the mesh's sizes, and no face of the twin is degenerate (so MT2 needs
    no filter)."""
    values, iso = FIELDS[field]()
    jv, jf = j_marching(values, iso)
    c = mt_bench.classify_emulated(values, iso)
    ev, ef = mt_bench.emit_emulated(values, iso, c)
    assert ev.dtype == np.float32 and ef.dtype == np.int64
    np.testing.assert_array_equal(ev, jv)
    np.testing.assert_array_equal(ef, jf)
    assert (int(c["totals"][1]), int(c["totals"][2])) == (len(jf), len(jv))
    assert ((jf[:, 0] != jf[:, 1]) & (jf[:, 1] != jf[:, 2]) & (jf[:, 0] != jf[:, 2])).all()
    flags = c["flags"].reshape(values.shape)
    if field == "nan":  # the edge crossed only inside NaN cubes is no mesh edge
        x, y, z = _nan_field()[1]
        assert (values[x, y, z] < iso) != (values[x, y, z + 1] < iso)
        assert not np.isnan(values[x, y, z:z + 2]).any() and flags[x, y, z] & 1 == 0
    if field == "box":  # mesh edges that start on each far face
        assert all((f & 0x7F).any() for f in (flags[-1], flags[:, -1], flags[:, :, -1]))


@pytest.mark.parametrize("lines_per_tile", [1, 3, 64])
def test_marching_design_emulation_other_tiles(lines_per_tile):
    """The emulation's line and tile bases with other tile sizes than the
    kernels' 32 lines (a tile of one line, a ragged last tile, a tile larger
    than a grid plane): the same mesh."""
    values, iso = FIELDS["box"]()
    jv, jf = j_marching(values, iso)
    ev, ef = mt_bench.marching_emulated(values, iso, lines_per_tile)
    np.testing.assert_array_equal(ev, jv)
    np.testing.assert_array_equal(ef, jf)


class _Sphere:
    """An analytic SDF geometry for both packages' extraction."""

    radius = 1.0

    def __init__(self, config_from_dict, norm):
        self.config = config_from_dict({"isosurface": {"resolution": 32, "chunk": 8192}})
        self.norm = norm

    def forward_level(self, params, points, step=None):
        return self.norm(points) - 0.55


def _canon(v, f):
    """Vertices sorted lexicographically and faces renumbered to match, each
    face rotated to start at its smallest index, faces sorted."""
    order = np.lexsort(v.T[::-1])
    rank = np.empty(len(v), np.int64)
    rank[order] = np.arange(len(v))
    f = rank[f]
    f = np.stack([np.roll(t, -int(np.argmin(t))) for t in f]) if len(f) else f
    return v[order], f[np.lexsort(f.T[::-1])]


def test_two_stage_extraction_keeps_the_grid_on_the_device():
    """The port's level grid is a float32 tensor on the model's device, and
    the two-stage extraction of an analytic sphere gives the JAX package's
    mesh (its native pass orders vertices by first use, the numpy twin by
    edge key: compared in a canonical order), within 1e-5."""
    geo = _Sphere(t_config, lambda p: torch.linalg.norm(p, dim=-1))
    vmin, vmax = np.full(3, -1.0, np.float32), np.ones(3, np.float32)
    grid = t_iso_model._eval_level_grid(geo, None, vmin, vmax, 16, 1000, torch.device("cpu"))
    assert torch.is_tensor(grid) and grid.dtype == torch.float32 and tuple(grid.shape) == (16,) * 3
    mesh = t_iso_model.extract_isosurface(geo, None, torch.device("cpu"))
    ref = j_extract(_Sphere(j_config, lambda p: jnp.linalg.norm(p, axis=-1)), None)
    assert mesh["v_pos"].dtype == np.float32 and mesh["t_pos_idx"].dtype == np.int64
    tv, tf = _canon(mesh["v_pos"], mesh["t_pos_idx"])
    jv, jf = _canon(np.asarray(ref["v_pos"]), np.asarray(ref["t_pos_idx"]))
    assert len(tv) == len(jv) > 100
    np.testing.assert_allclose(tv, jv, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(tf, jf)


@pytest.mark.parametrize("colours", [False, True])
def test_obj_writer_matches_jax_bytes(tmp_path, colours):
    """``save_obj`` writes the JAX package's bytes: values that round on a
    tie at the 6th / 4th decimal, signed zeros, tiny and huge magnitudes,
    NaN and infinities, and an empty mesh."""
    rs = np.random.RandomState(0)
    n = 5000
    v = (rs.randn(n, 3) * rs.choice([1e-8, 1e-3, 1.0, 100.0, 1e6], (n, 3))).astype(np.float32)
    v[:6] = [[2.0 ** -7, -0.0, 5e-7], [0.0234375, 0.1171875, 1 / 3], [np.nan, np.inf, -np.inf],
             [-np.nan, 3.4e38, -1e-9], [1e7, -1e7, 123456.789], [0.0, 0.0, 0.0]]
    f = rs.randint(0, n, (2 * n, 3))
    c = rs.rand(n, 3).astype(np.float32) if colours else None
    if colours:
        c[:2] = [[0.00005, 0.00015, 0.99995], [2.0 ** -5, 0.5, 1.0]]
    for name, (vv, ff, cc) in {"mesh": (v, f, c),
                               "empty": (np.zeros((0, 3)), np.zeros((0, 3)),
                                         np.zeros((0, 3)) if colours else None)}.items():
        t_save_obj(str(tmp_path), f"{name}-port.obj", vv, ff, cc)
        j_save_obj(str(tmp_path), f"{name}-jax.obj", vv, ff, cc)
        with open(os.path.join(tmp_path, f"{name}-port.obj"), "rb") as a, \
                open(os.path.join(tmp_path, f"{name}-jax.obj"), "rb") as b:
            assert a.read() == b.read(), name


@pytest.mark.parametrize("colours", [False, True])
def test_obj_reader_blocks_match_line_reader(tmp_path, colours):
    """``load_obj`` parses what ``save_obj`` writes as whole blocks of lines;
    it gives what the line-by-line reader (``load_obj_by_line``, the
    reference) gives, NaN, infinities and an empty mesh included, and falls
    back to that reader for polygons with texture indices and indented
    lines."""
    from instant_nsr_pl_tpu_torch.utils.savers import load_obj, load_obj_by_line

    rs = np.random.RandomState(1)
    n = 3000
    v = (rs.randn(n, 3) * rs.choice([1e-8, 1.0, 1e6], (n, 3))).astype(np.float32)
    v[:3] = [[np.nan, np.inf, -np.inf], [-np.nan, 3.4e38, -1e-9], [0.0, -0.0, 0.0]]
    f = rs.randint(0, n, (2 * n, 3))
    c = rs.rand(n, 3).astype(np.float32) if colours else None
    odd = os.path.join(tmp_path, "odd.obj")
    with open(odd, "w") as fh:
        fh.write("# a quad with texture indices\nv 0 0 0\nv 1 0 0\n  v 1 1 0\nv 0 1 0\n"
                 "vt 0 0\nf 1/1 2/2 3/3 4/4\n")
    for name, (vv, ff, cc) in {"mesh": (v, f, c),
                               "empty": (np.zeros((0, 3)), np.zeros((0, 3)), None)}.items():
        path = t_save_obj(str(tmp_path), f"{name}.obj", vv, ff, cc)
        for p in (path, odd):
            with open(p) as fh:
                ref = load_obj_by_line(fh.read().splitlines())
            got = load_obj(p)
            assert sorted(got) == sorted(ref), (name, p)
            for k in ref:
                assert got[k].dtype == ref[k].dtype, k
                np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert load_obj(odd)["t_pos_idx"].tolist() == [[0, 1, 2], [0, 2, 3]]
