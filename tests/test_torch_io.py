"""The port's I/O (minipic_torch/io) against the JAX package's: params.txt
byte for byte, HDF5 field and particle snapshots dataset for dataset, the
native writer against the h5py writer, checkpoints loaded across both
packages both ways, and a resume through the API bit for bit."""
import importlib.util
import os
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: the suite runs in parallel worker processes, and
# their OpenMP threads oversubscribing the cores slow a step ~85x.
torch.set_num_threads(1)

from minipic_tpu.core import config as jcfg  # noqa: E402
from minipic_tpu.core.state import FieldState as JFieldState  # noqa: E402
from minipic_tpu.decks import standard as jstd  # noqa: E402
from minipic_tpu.io import checkpoint as jckpt  # noqa: E402
from minipic_tpu.io import hdf5 as jh5  # noqa: E402
from minipic_tpu.io import params as jparams  # noqa: E402
from minipic_tpu.simulation import Simulation as JSimulation  # noqa: E402
from minipic_torch import bridge  # noqa: E402
from minipic_torch.core import config as tcfg  # noqa: E402
from minipic_torch.core.state import FieldState  # noqa: E402
from minipic_torch.decks import standard as tstd  # noqa: E402
from minipic_torch.fields import init as tinit  # noqa: E402
from minipic_torch.io import checkpoint as tckpt  # noqa: E402
from minipic_torch.io import hdf5 as th5  # noqa: E402
from minipic_torch.io import native  # noqa: E402
from minipic_torch.io import params as tparams  # noqa: E402
from minipic_torch.particles.binning import tile_counts  # noqa: E402
from minipic_torch.simulation import Simulation  # noqa: E402

h5py = pytest.importorskip("h5py")

CPU = torch.device("cpu")
PORTED = ("reference_pulse", "two_stream", "weibel", "landau",
          "laser_plasma", "laser_wakefield_window")
GRID = dict(box_x=10.0, box_y=10.0, nx=48, ny=48, tile_nx=8, tile_ny=8)
# The reference's own reader: the path of its File_reader.py, given in the
# environment (the test skips without it).
REFERENCE_READER = os.environ.get("MINIPIC_REFERENCE_READER", "")


def _h5_dump(path):
    """{group: ({attr: (value, dtype)}, {dataset: array})} of a file."""
    out = {}
    with h5py.File(path, "r") as f:
        for name, grp in f.items():
            attrs = {k: (grp.attrs[k], grp.attrs[k].dtype) for k in grp.attrs}
            out[name] = (attrs, {k: grp[k][()] for k in grp})
    return out


def _same_files(folder_a, folder_b):
    """The two folders hold the same .h5 files, group for group: equal
    attributes and attribute dtypes, equal datasets and dataset dtypes."""
    names = sorted(p for p in os.listdir(folder_a) if p.endswith(".h5"))
    assert names == sorted(p for p in os.listdir(folder_b)
                           if p.endswith(".h5"))
    assert names
    for n in names:
        a = _h5_dump(os.path.join(folder_a, n))
        b = _h5_dump(os.path.join(folder_b, n))
        assert sorted(a) == sorted(b), n
        for g in a:
            (aa, da), (ab, db) = a[g], b[g]
            assert sorted(aa) == sorted(ab), (n, g)
            for k in aa:
                assert aa[k][0] == ab[k][0] and aa[k][1] == ab[k][1], (n, g, k)
            assert sorted(da) == sorted(db), (n, g)
            for k in da:
                assert da[k].dtype == db[k].dtype, (n, g, k)
                assert np.array_equal(da[k], db[k]), (n, g, k)
    return names


def _random_fields(ny, nx, dtype, seed=5):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((ny, nx)).astype(dtype) for _ in range(6)]


def _save_both(tmp_path, comps, tiling, guard, ranks=1, owner=None):
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    jh5.save_fields(JFieldState(*comps), tiling, guard, 7, jdir, ranks=ranks,
                    owner=owner)
    tf = FieldState(*(torch.from_numpy(c) for c in comps))
    paths = th5.save_fields(tf, tiling, guard, 7, tdir, ranks=ranks,
                            owner=owner)
    assert len(paths) == ranks
    return jdir, tdir


@pytest.mark.parametrize("name", PORTED)
def test_params_txt_equals_jax_byte_for_byte(tmp_path, name):
    jd, td = jstd.make(name).deck, tstd.make(name).deck
    jp = jparams.write_params(jd, str(tmp_path / "jax"))
    tp = tparams.write_params(td, str(tmp_path / "torch"))
    assert Path(tp).read_bytes() == Path(jp).read_bytes()
    got, want = tparams.read_params(tp), jparams.read_params(jp)
    assert got == want
    assert got["nx_global"] == td.nx and got["dt"] == td.dt


@pytest.mark.parametrize("dtype,ranks", [(np.float32, 1), (np.float32, 4),
                                         (np.float64, 1), (np.float64, 4)])
def test_field_snapshot_equals_jax(tmp_path, dtype, ranks):
    """The same fields through both packages' save_fields: the same files,
    dataset for dataset; load_field round-trips them."""
    deck = tcfg.Deck(**GRID)
    comps = _random_fields(48, 48, dtype)
    jdir, tdir = _save_both(tmp_path, comps, deck.tiling, deck.guard, ranks)
    assert len(_same_files(jdir, tdir)) == ranks
    kw = dict(nx_global=48, ny_global=48, guard=deck.guard, interior_nx=8,
              interior_ny=8)
    for c, q in zip(comps, ("Ex", "Ey", "Ez", "Bx", "By", "Bz")):
        got = th5.load_field(7, tdir, q, **kw)
        assert got.dtype == np.float64
        np.testing.assert_array_equal(got, c.astype(np.float64))
    assert th5.available_steps(tdir) == [7]


def test_field_snapshot_with_owner_map_equals_jax(tmp_path):
    deck = tcfg.Deck(**GRID)
    owner = np.random.default_rng(3).integers(0, 3, deck.tiling.num_tiles)
    comps = _random_fields(48, 48, np.float64)
    jdir, tdir = _save_both(tmp_path, comps, deck.tiling, deck.guard, 3, owner)
    assert len(_same_files(jdir, tdir)) == 3
    with h5py.File(os.path.join(tdir, "fields_rank_1_step_7.h5")) as f:
        gids = sorted(int(g.split("_")[1]) for g in f)
        assert gids == list(np.nonzero(owner == 1)[0])
        assert all(int(f[g].attrs["currentRank"]) == 1 for g in f)


def test_reference_pulse_snapshot_equals_jax(tmp_path):
    """reference_pulse at 50^2: 25x25 tiles, guard 2, the pulse's fields
    from each package's init (f32), written by each package."""
    jcase, tcase = (jstd.make("reference_pulse", nx=50, ny=50),
                    tstd.make("reference_pulse", nx=50, ny=50))
    d = tcase.deck
    assert (d.tile_nx, d.tile_ny, d.guard) == (25, 25, 2)
    tf = tcase.init_fields(d, device=CPU)
    comps = [c.numpy() for c in tf]
    jf = jcase.init_fields(jcase.deck)
    for a, b in zip(comps, jf):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-7)
    jdir, tdir = _save_both(tmp_path, comps, d.tiling, d.guard, ranks=2)
    _same_files(jdir, tdir)
    with h5py.File(os.path.join(tdir, "fields_rank_0_step_7.h5")) as f:
        assert f["Tile_0"]["fields"].shape == (29, 29)


def test_reference_file_reader_loads_the_ports_files(tmp_path):
    if not os.path.isfile(REFERENCE_READER):
        pytest.skip("MINIPIC_REFERENCE_READER names no File_reader.py")
    os.environ.setdefault("MPLBACKEND", "Agg")
    spec = importlib.util.spec_from_file_location("ref_file_reader",
                                                  REFERENCE_READER)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    deck = tcfg.Deck(**GRID, precision="f64")
    f = tinit.pulse_x(deck.domain, dtype=torch.float64, device=CPU)
    folder = str(tmp_path / "Fields")
    th5.save_fields(f, deck.tiling, deck.guard, 0, folder, ranks=4)
    got = mod.load_field(step=0, folder=folder, quantity="Bz", box_x=10.0,
                         box_y=10.0, nx_global=48, ny_global=48, guard=2,
                         interior_nx=8, interior_ny=8)
    np.testing.assert_array_equal(got, f.bz.numpy())
    tparams.write_params(deck, folder)
    p = mod.read_params(os.path.join(folder, "params.txt"))
    assert p["nx_global"] == 48 and p["guard"] == 2


def _particle_deck(cfg, **kw):
    return cfg.Deck(box_x=4.0, box_y=4.0, nx=16, ny=16, tile_nx=8, tile_ny=8,
                    species=(cfg.SpeciesSpec("e", -1.0, 1.0, ppc=2, ux=0.1,
                                             uth=0.05),
                             cfg.SpeciesSpec("i", +1.0, 100.0, ppc=2)),
                    **kw)


def _canon(q):
    """Per-bucket live rows sorted by (x, y, px): order-insensitive (as
    tests/test_deal_route.py)."""
    out = []
    for arrs in zip(*(np.asarray(g) for g in q)):
        rows = np.stack(arrs, -1)
        live = rows[rows[:, 5] > 0]
        out.append(live[np.lexsort((live[:, 2], live[:, 1], live[:, 0]))])
    return out


def _stepped_jax(deck, steps=2, **kw):
    jsim = JSimulation(deck, **kw)
    jsim.step(steps)
    return jsim


@pytest.mark.parametrize("kchunk", [0, 128])
def test_particle_snapshot_equals_jax_and_restores(tmp_path, kchunk):
    """The same buckets through both packages' save_particles: the same
    file.  particles_from_snapshot restores each bucket's live multiset as
    JAX's does; at whole-bucket chunks (kchunk 0) the port's capacity is
    in its 512-slot quantum, JAX's in 128 (ROADMAP C)."""
    jd = _particle_deck(jcfg, kchunk=kchunk)
    td = _particle_deck(tcfg, kchunk=kchunk)
    jsim = _stepped_jax(jd)
    tstate = bridge.sim_state_from_numpy(bridge.sim_state_to_numpy(
        jsim.state), CPU)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    jh5.save_particles(jsim.state.species, ["e", "i"], 2, jdir)
    th5.save_particles(tstate.species, ["e", "i"], 2, tdir)
    _same_files(jdir, tdir)
    data = th5.load_particles(2, tdir)
    assert sorted(data) == ["e", "i"]

    want = jckpt.particles_from_snapshot(2, jdir, jd)
    got = tckpt.particles_from_snapshot(2, tdir, td, device=CPU)
    for g, w, p in zip(got, want, tstate.species):
        # JAX: max(deck capacity, densest tile in 128s or kchunks); the
        # port: the larger of the two, in its bucket quantum.
        assert w.capacity == jd.capacity() == td.capacity()
        assert g.capacity == -(-td.capacity() // (kchunk or 512)) * (
            kchunk or 512)
        for a, b in zip(_canon(g), _canon(w)):
            assert a.shape == b.shape
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(tile_counts(g).numpy(),
                                      tile_counts(p).numpy())


def test_fields_from_snapshot_bit_for_bit(tmp_path):
    deck = tcfg.Deck(**GRID)
    comps = _random_fields(48, 48, np.float32)
    jdir, tdir = _save_both(tmp_path, comps, deck.tiling, deck.guard, 4)
    got = tckpt.fields_from_snapshot(7, tdir, deck, device=CPU)
    want = jckpt.fields_from_snapshot(7, jdir, jcfg.Deck(**GRID))
    for g, w, c in zip(got, want, comps):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), c)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.fixture
def native_writer():
    if not native.available():
        pytest.skip("native writer unavailable (no g++ or libhdf5 runtime)")
    return native


@pytest.mark.parametrize("ranks", [1, 4])
def test_native_writer_equals_h5py_writer(tmp_path, native_writer, ranks):
    deck = tcfg.Deck(**GRID)
    f = FieldState(*(torch.from_numpy(c)
                     for c in _random_fields(48, 48, np.float32)))
    hdir, ndir = str(tmp_path / "h5py"), str(tmp_path / "native")
    th5.save_fields(f, deck.tiling, deck.guard, 3, hdir, ranks=ranks)
    jsim = _stepped_jax(_particle_deck(jcfg))
    st = bridge.sim_state_from_numpy(bridge.sim_state_to_numpy(jsim.state),
                                     CPU)
    th5.save_particles(st.species, ["e", "i"], 3, hdir)
    w = native_writer.AsyncSnapshotWriter(deck.tiling, deck.guard, ndir,
                                          ranks=ranks)
    before = w.written()
    w.submit(f, 3)
    w.submit_particles(st.species, ["e", "i"], 3)
    assert w.flush() == 0
    assert w.written() - before == ranks + 1
    assert len(_same_files(hdir, ndir)) == ranks + 1
    built = Path(native_writer.BUILD_DIR)
    assert list(built.glob("*/libmpw.so"))
    assert not list(Path(native_writer.__file__).parent.glob("*.so"))


def test_native_writer_is_asynchronous(tmp_path, native_writer):
    """Ten submits return before their files are waited for; flush drains
    them all."""
    deck = tcfg.Deck(**GRID)
    f = tinit.pulse_x(deck.domain, dtype=torch.float32, device=CPU)
    out = str(tmp_path / "many")
    w = native_writer.AsyncSnapshotWriter(deck.tiling, deck.guard, out)
    for s in range(10):
        w.submit(f, s)
    assert w.flush() == 0
    assert len([p for p in os.listdir(out) if p.endswith(".h5")]) == 10


def _assert_states_equal(a, b):
    for x, y in zip(a.fields, b.fields):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x.numpy(), y.numpy())
    assert len(a.species) == len(b.species)
    for pa, pb in zip(a.species, b.species):
        for x, y in zip(pa, pb):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x.numpy(), y.numpy())
    assert int(a.step) == int(b.step)


@pytest.mark.parametrize("precision", ["f64", "f32"])
def test_checkpoint_resume_is_exact(tmp_path, precision):
    """Checkpoint after 3 steps, load, 4 more steps: the 7 straight steps
    bit for bit (tests/test_io.py's resume, on the port)."""
    deck = _particle_deck(tcfg, precision=precision)
    fields = tinit.pulse_x(deck.domain, dtype=deck.dtype, device=CPU)
    sim = Simulation(deck, fields=fields, device="cpu")
    sim.step(3)
    ckpt = str(tmp_path / "state.npz")
    tckpt.save_checkpoint(ckpt, sim.state)
    sim.step(4)
    sim2 = Simulation(deck, device="cpu")
    sim2.state = tckpt.load_checkpoint(ckpt, deck, device="cpu")
    assert int(sim2.state.step) == 3
    sim2.step(4)
    _assert_states_equal(sim.state, sim2.state)
    assert float(sim.state.drift) == float(sim2.state.drift)


def _step_twin_deck(cfg, **kw):
    """tests/test_torch_step.py's 32^2 headline-shaped deck (sort re-bin)."""
    return cfg.Deck(
        box_x=3.2, box_y=3.2, nx=32, ny=32, tile_nx=8, tile_ny=8, guard=4,
        species=(cfg.SpeciesSpec("ele", charge=-1.0, mass=1.0, ppc=8,
                                 uth=0.1, ux=0.05, shape_order=2),),
        precision="f32", capacity_headroom=1.1, kchunk=0, deposit="int8",
        rebin_mode="sort", **kw)


def test_jax_checkpoint_steps_in_the_port_as_in_jax(tmp_path):
    """A JAX checkpoint loads into the port, and both step it 12 more
    steps (a re-bin included), held to the step twin's tolerances."""
    jsim = JSimulation(_step_twin_deck(jcfg, use_pallas="on"), seed=1)
    jsim.step(3)
    ckpt = str(tmp_path / "jax.npz")
    jckpt.save_checkpoint(ckpt, jsim.state)
    tdeck = _step_twin_deck(tcfg)
    tsim = Simulation(tdeck, device="cpu")
    tsim.state = tckpt.load_checkpoint(ckpt, tdeck, device="cpu")
    want = bridge.sim_state_to_numpy(jsim.state)
    got = bridge.sim_state_to_numpy(tsim.state)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    rebins = 0
    for i in range(12):
        dj, dt_ = jsim.step(), tsim.step()
        np.testing.assert_allclose(float(dt_.field_energy),
                                   float(dj.field_energy), rtol=1e-4,
                                   atol=1e-12, err_msg=f"step {i}")
        np.testing.assert_allclose(dt_.kinetic_energy.numpy(),
                                   np.asarray(dj.kinetic_energy), rtol=1e-5,
                                   err_msg=f"step {i}")
        reset = float(tsim.state.drift) == 0.0
        assert reset == (float(jsim.state.drift) == 0.0), f"step {i}"
        if reset:
            rebins += 1
            p, jp = tsim.state.species[0], jsim.state.species[0]
            w = p.w.numpy()
            np.testing.assert_array_equal(w, np.asarray(jp.w))
            np.testing.assert_allclose(p.x.numpy()[w > 0],
                                       np.asarray(jp.x)[w > 0], rtol=0,
                                       atol=1e-4)
    assert rebins >= 1
    assert int(tsim.state.step) == int(jsim.state.step) == 15


def test_checkpoints_carry_drift_and_window_both_ways(tmp_path):
    """A window deck's state: JAX's checkpoint loads into the port and the
    port's into JAX's load_checkpoint, every array equal, drift and
    window_x0 included."""
    name, kw = "laser_wakefield_window", dict(nx=64, ny=32, ppc=2)
    jcase = jstd.make(name, **kw)
    jsim = JSimulation(jcase.deck, fields=jcase.init_fields(jcase.deck))
    jsim.step(2)
    jsim.state = jsim.state._replace(window_x0=jnp.asarray(16, jnp.int32),
                                     drift=jnp.asarray(0.375, jnp.float32))
    jpath, tpath = str(tmp_path / "jax.npz"), str(tmp_path / "torch.npz")
    jckpt.save_checkpoint(jpath, jsim.state)
    tdeck = tstd.make(name, **kw).deck
    tstate = tckpt.load_checkpoint(jpath, tdeck, device="cpu")
    assert int(tstate.window_x0) == 16 and float(tstate.drift) == 0.375
    tckpt.save_checkpoint(tpath, tstate)
    with np.load(jpath) as zj, np.load(tpath) as zt:
        assert sorted(zj.files) == sorted(zt.files)
        for k in zj.files:
            assert zj[k].dtype == zt[k].dtype, k
            np.testing.assert_array_equal(zj[k], zt[k], err_msg=k)
    back = jckpt.load_checkpoint(tpath, jcase.deck)
    want = bridge.sim_state_to_numpy(jsim.state)
    got = bridge.sim_state_to_numpy(back)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("name,kw", [
    ("laser_wakefield_window", dict(nx=64, ny=32, ppc=2)),
    ("two_stream", dict(nx=32, ny=32)),
])
def test_checkpoint_without_drift_restores_as_jax(tmp_path, name, kw):
    """An older checkpoint (no drift, no window_x0) restores the drift and
    window origin that JAX's load_checkpoint does, with the deck and
    without."""
    jcase, tcase = jstd.make(name, **kw), tstd.make(name, **kw)
    jsim = JSimulation(jcase.deck)
    path = str(tmp_path / "old.npz")
    jckpt.save_checkpoint(path, jsim.state)
    with np.load(path) as z:
        kept = {k: z[k] for k in z.files if k not in ("drift", "window_x0")}
    np.savez(path, **kept)
    for jd, td in ((jcase.deck, tcase.deck), (None, None)):
        want = jckpt.load_checkpoint(path, jd)
        got = tckpt.load_checkpoint(path, td, device="cpu")
        assert got.drift.dtype == torch.float32
        assert float(got.drift) == float(want.drift)
        assert (got.window_x0 is None) == (want.window_x0 is None)
        if want.window_x0 is not None:
            assert got.window_x0.dtype == torch.int32
            assert int(got.window_x0) == int(want.window_x0) == 0


def test_load_checkpoint_targets_the_card_by_default(tmp_path):
    """load_checkpoint puts the state on the card unless asked otherwise:
    without one it fails rather than fall back to the CPU."""
    deck = tcfg.Deck(**GRID)
    path = str(tmp_path / "c.npz")
    tckpt.save_checkpoint(path, Simulation(deck, device="cpu").state)
    if torch.cuda.is_available():
        assert tckpt.load_checkpoint(path).step.device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            tckpt.load_checkpoint(path)
    state = tckpt.load_checkpoint(path, device="cpu")
    assert state.window_x0 is None and int(state.step) == 0
