"""The port's coronary oracle (tpinn_torch/oracles/{mesh, io, fem, coronary,
coro_param, coro_geometry}.py) against the JAX package's (tpinn/oracles),
both numpy/scipy on the host:

* the gmsh reader, the boundary-point files and the committed copies the
  package carries (byte for byte, SHA-256 constants);
* the boundary helpers (refinement, classification, node matching,
  outflow edges) equal;
* the steady solve on the committed mesh equal to the committed
  SteadyCase fields (0.0 measured, bar 1e-12·max|field|), whose norms the
  port keeps as constants; the refine-1 path on a coarse parametric mesh
  and three unsteady steps equal to tpinn's;
* the numpy even-odd test equal to matplotlib's ``Path.contains_points``
  on the mesher's hex-grid candidates, the mesher equal to tpinn's, the
  gmsh writer round trip;
* the cache found in either layout (h5 or npz).
"""

import os

import numpy as np
import pytest
import torch

from tpinn.oracles import coro_geometry as jgeo
from tpinn.oracles import coro_param as jparam
from tpinn.oracles import coronary as jcoro
from tpinn.oracles import io as jio
from tpinn.oracles import mesh as jmesh
from tpinn_torch.oracles import coro_geometry as tgeo
from tpinn_torch.oracles import coro_param as tparam
from tpinn_torch.oracles import coronary as tcoro
from tpinn_torch.oracles import io as tio
from tpinn_torch.oracles import mesh as tmesh

torch.set_num_threads(1)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_EXAMPLE = os.path.join(_REPO, "examples", "Coronary_Flow")
MSH = os.path.join(_EXAMPLE, "coroParam.msh")
BPTS = os.path.join(_EXAMPLE, "bpoints.npy")
STEADY_H5 = os.path.join(_EXAMPLE, "data", "SteadyCase",
                         "steady_coronary_steady.h5")
COARSE = dict(size_factor=0.35)
FIELD_BAR = 1e-12


@pytest.fixture(scope="module")
def meshes():
    return jmesh.read_gmsh(MSH), tmesh.read_gmsh(MSH)


@pytest.fixture(scope="module")
def coarse_msh(tmp_path_factory):
    """tpinn's coarse parametric mesh, written in gmsh 4.1."""
    nodes, tris = jparam.mesh_coronary(jparam.CoroGeoParams(**COARSE),
                                       seed=0)
    path = str(tmp_path_factory.mktemp("coarse") / "coarse.msh")
    jparam.write_gmsh41(path, nodes, tris)
    return path, nodes, tris


def test_read_gmsh_equals_tpinn(meshes):
    ref, got = meshes
    assert got.nodes.shape == (10833, 3) and got.triangles.shape == (20864, 3)
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(b, a)
        assert b.dtype == a.dtype


def test_load_bpoints_equals_tpinn():
    ref, got = jio.load_bpoints(BPTS), tio.load_bpoints(BPTS)
    assert list(got) == list(ref) == ["NOSL", "INF", "OUT1", "OUT2"]
    assert [len(v) for v in got.values()] == [701, 33, 33, 33]
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k])
    arr = np.load(BPTS)
    for k, v in tio.bpoints_to_dict(arr).items():
        np.testing.assert_array_equal(v, jio.bpoints_to_dict(arr)[k])


def test_packaged_copies_are_the_committed_files():
    for packaged, committed, digest in (
            (tcoro.MESH_PATH, MSH, tcoro.MESH_SHA256),
            (tcoro.BPOINTS_PATH, BPTS, tcoro.BPOINTS_SHA256)):
        with open(packaged, "rb") as f, open(committed, "rb") as g:
            assert f.read() == g.read()
        assert tcoro.sha256(packaged) == tcoro.sha256(committed) == digest
    assert os.path.getsize(tcoro.MESH_PATH) == 959_600
    assert os.path.getsize(tcoro.BPOINTS_PATH) == 25_728


@pytest.mark.parametrize("tol", [1e-14, 1e-9])
def test_generate_bpoints_equals_tpinn(tol):
    ref = jcoro.generate_bpoints(MSH, tol=tol)
    got = tcoro.generate_bpoints(MSH, tol=tol)
    np.testing.assert_array_equal(got, ref)
    assert np.bincount(got[:, 3].astype(int)).tolist() == [701, 33, 33, 33]


def test_boundary_helpers_equal_tpinn(meshes):
    mesh = meshes[1]
    nodes, tris = mesh.nodes[:, :2], mesh.triangles
    for a, b in zip(jcoro.refine_uniform(nodes, tris),
                    tcoro.refine_uniform(nodes, tris)):
        np.testing.assert_array_equal(b, a)
    ball = tcoro.boundary_vertices(mesh)
    np.testing.assert_array_equal(ball, jcoro.boundary_vertices(meshes[0]))
    np.testing.assert_array_equal(tcoro.classify_boundary(nodes, ball),
                                  jcoro.classify_boundary(nodes, ball))
    bp = tio.load_bpoints(BPTS)
    ref, got = (jcoro.match_boundary_nodes(nodes, bp),
                tcoro.match_boundary_nodes(nodes, bp))
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k])
    np.testing.assert_array_equal(tcoro.outflow_edges(nodes, tris),
                                  jcoro.outflow_edges(nodes, tris))
    assert len(tcoro.outflow_edges(nodes, tris)) == 64


def test_field_norms_are_the_committed_files():
    u, v, p = jio.read_fields_h5(STEADY_H5)
    for name, a in zip("uvp", (u, v, p)):
        assert tcoro.FIELD_NORMS[name] == (float(np.max(np.abs(a))),
                                           float(np.linalg.norm(a)))


def test_solve_coronary_reproduces_the_committed_fields():
    counts = {}
    nodes, u, v, p = tcoro.solve_coronary(tcoro.MESH_PATH,
                                          tcoro.BPOINTS_PATH, counts=counts)
    np.testing.assert_array_equal(nodes, jio.read_mesh_geometry_h5(STEADY_H5))
    for got, ref in zip((u, v, p), jio.read_fields_h5(STEADY_H5)):
        assert np.max(np.abs(got - ref)) <= FIELD_BAR * np.max(np.abs(ref))
    assert counts["picard"] == 10


def test_refine_1_on_the_coarse_mesh_equals_tpinn(coarse_msh):
    path = coarse_msh[0]
    ref = jcoro.solve_coronary(path, None, picard_iters=10, refine=1)
    got = tcoro.solve_coronary(path, None, picard_iters=10, refine=1)
    assert got[0].shape == coarse_msh[1].shape
    for a, b in zip(ref, got):
        assert np.max(np.abs(b - a)) <= FIELD_BAR * np.max(np.abs(a))


def test_unsteady_three_steps_equal_tpinn(tmp_path):
    jfolder = jcoro.generate_coronary_unsteady(str(tmp_path / "jax"), MSH,
                                               t_end=3e-4, dt=1e-4)
    tfolder = tcoro.generate_coronary_unsteady(str(tmp_path / "port"), MSH,
                                               t_end=3e-4, dt=1e-4)
    assert os.path.basename(tfolder) == "Coronary"
    for it in range(3):
        ref = jio.read_fields_h5(jio.unsteady_h5_path(
            jfolder, it, formulation="navier-stokes_SI", testcase="coronary"))
        path = tio.find_unsteady_path(tfolder, it, "coronary")
        assert os.path.basename(path) == os.path.basename(
            jio.unsteady_h5_path(jfolder, it, testcase="coronary"))
        assert os.path.exists(os.path.splitext(path)[0] + ".xdmf")
        got = tio.read_fields(path)
        for a, b in zip(ref, got):
            scale = max(np.max(np.abs(a)), 1e-300)
            assert np.max(np.abs(b - a)) <= FIELD_BAR * scale
    assert np.max(np.abs(got[0])) > 0.1
    np.testing.assert_array_equal(np.load(os.path.join(tfolder, "bpoints.npy")),
                                  np.load(os.path.join(jfolder, "bpoints.npy")))


@pytest.mark.parametrize("formulation",
                         ["navier-stokes_SI", "stokes", "navier-stokes_I"])
def test_fem_formulations_equal_tpinn(coarse_msh, formulation):
    """The unsteady solver's three formulations (two steps, the outflow
    surface term on) and the Stokes solve on the coarse mesh."""
    from tpinn.oracles import fem as jfem
    from tpinn_torch.oracles import fem as tfem

    _, nodes, tris = coarse_msh
    ball = tcoro.boundary_vertices_of(tris)
    marks = tcoro.classify_boundary(nodes, ball)
    dirichlet = tcoro._dirichlet(nodes, ball[marks == 0], ball[marks == 1],
                                 tcoro.CoronaryParams())
    edges = tcoro.outflow_edges(nodes, tris)
    kw = dict(nu=tcoro.CoronaryParams().ni, dirichlet=dirichlet, t_end=2e-4,
              dt=1e-4, pressure_outflow_edges=edges, formulation=formulation)
    (t_ref, ref), (t_got, got) = (
        jfem.solve_navier_stokes_unsteady(nodes, tris, **kw),
        tfem.solve_navier_stokes_unsteady(nodes, tris, **kw))
    np.testing.assert_array_equal(t_got, t_ref)
    pairs = [(a, b) for sr, sg in zip(ref, got) for a, b in zip(sr, sg)]
    if formulation == "stokes":
        pairs += list(zip(jfem.solve_stokes(nodes, tris, 1.0, dirichlet),
                          tfem.solve_stokes(nodes, tris, 1.0, dirichlet)))
    for a, b in pairs:
        assert np.max(np.abs(b - a)) <= FIELD_BAR * max(np.max(np.abs(a)),
                                                        1e-300)
    with pytest.raises(ValueError, match="formulation"):
        tfem.solve_navier_stokes_unsteady(nodes, tris, **{
            **kw, "formulation": "euler"})


@pytest.mark.parametrize("params", [{}, COARSE], ids=["default", "coarse"])
def test_points_in_polygon_equals_matplotlib(params):
    """The hex-grid candidates of ``mesh_coronary`` (1,792,175 points for
    the default geometry), inside or not, as matplotlib decides."""
    from matplotlib.path import Path

    bnd, sizes = tparam.boundary_polyline(tparam.CoroGeoParams(**params))
    h0 = float(sizes.min())
    x0, y0 = bnd.min(0) - 0.05
    x1, y1 = bnd.max(0) + 0.05
    gx, gy = np.meshgrid(np.arange(x0, x1, h0),
                         np.arange(y0, y1, h0 * np.sqrt(3) / 2))
    gx[1::2] += h0 / 2
    pts = np.stack([gx.ravel(), gy.ravel()], axis=1)
    got = tparam.points_in_polygon(pts, bnd)
    np.testing.assert_array_equal(got, Path(bnd).contains_points(pts))
    assert 0 < got.sum() < len(pts)


def test_mesher_equals_tpinn(coarse_msh):
    nodes, tris = tparam.mesh_coronary(tparam.CoroGeoParams(**COARSE),
                                       seed=0)
    np.testing.assert_array_equal(nodes, coarse_msh[1])
    np.testing.assert_array_equal(tris, coarse_msh[2])


def test_gmsh_writer_round_trip(coarse_msh, tmp_path):
    _, nodes, tris = coarse_msh
    path = str(tmp_path / "round.msh")
    tparam.write_gmsh41(path, nodes, tris)
    with open(path) as f, open(coarse_msh[0]) as g:
        assert f.read() == g.read()
    mesh = tmesh.read_gmsh(path)
    # %.16g text: within an ulp of coordinates below 2 in magnitude
    np.testing.assert_allclose(mesh.nodes[:, :2], nodes, rtol=0, atol=1e-15)
    np.testing.assert_array_equal(mesh.triangles, tris)
    np.testing.assert_array_equal(mesh.node_tags, np.arange(1, len(nodes) + 1))
    with pytest.raises(ValueError, match="gmsh format"):
        (tmp_path / "bad.msh").write_text("$MeshFormat\n2.2 0 8\n"
                                          "$EndMeshFormat\n")
        tmesh.read_gmsh(str(tmp_path / "bad.msh"))


def test_stenosis_profile_and_sketch(tmp_path):
    x = np.linspace(-10, 10, 101)
    for kw in ({}, {"channel_height": 4.0, "c": 0.5}):
        np.testing.assert_array_equal(tgeo.stenosis_profile(x, **kw),
                                      jgeo.stenosis_profile(x, **kw))
    pytest.importorskip("matplotlib")
    tgeo.sketch(filename=str(tmp_path / "sketch.png"))
    assert (tmp_path / "sketch.png").stat().st_size > 0


@pytest.mark.parametrize("layout", ["h5", "npz"])
def test_generator_finds_its_cache_in_either_layout(tmp_path, monkeypatch,
                                                    layout):
    """A SteadyCase folder holding the fields (h5 or npz) and bpoints.npy is
    the cache: nothing is solved, and the case's reader reads it."""
    folder = tmp_path / "SteadyCase"
    folder.mkdir()
    u, v, p = jio.read_fields_h5(STEADY_H5)
    nodes = jio.read_mesh_geometry_h5(STEADY_H5)
    tio.write_fields(str(folder / f"{tcoro.STEADY_STEM}.{layout}"), u, v, p,
                     geometry=nodes)
    np.save(folder / "bpoints.npy", np.load(BPTS))

    def no_solve(*a, **k):
        raise AssertionError("solved although the cache exists")

    monkeypatch.setattr(tcoro, "solve_coronary", no_solve)
    assert tcoro.generate_coronary(str(tmp_path), MSH, BPTS) == str(folder)
    path = tcoro.steady_fields_path(str(folder))
    assert path.endswith(layout)
    for a, b in zip((u, v, p), tio.read_fields(path)):
        np.testing.assert_array_equal(b, a)
    np.testing.assert_array_equal(tio.read_mesh_geometry(path), nodes)
    # without the cache the generator solves, writing the layout h5py allows
    monkeypatch.setattr(tio.utils, "has_module", lambda name: False)
    monkeypatch.setattr(tcoro, "solve_coronary", lambda *a, **k: (
        nodes, u, v, p))
    out = tcoro.generate_coronary(str(tmp_path / "new"), MSH)
    assert sorted(os.listdir(out)) == ["bpoints.npy",
                                       f"{tcoro.STEADY_STEM}.npz"]
    np.testing.assert_array_equal(np.load(os.path.join(out, "bpoints.npy")),
                                  jcoro.generate_bpoints(MSH))
