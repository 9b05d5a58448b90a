"""The step's diagnostics entry points (``minipic_torch/ops/diag.py``) on
CPU tensors: each equals, bit for bit, the plain functions the step took
before them (``core.state``'s energies and momentum, the live count and the
int8 deposit's uniform-weight guard), over float32 and float64 channels,
buckets with holes and an empty species.  The CUDA kernels behind them are
held to the same functions on the card (tests/test_torch_gpu.py)."""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from minipic_torch.core import state as cs  # noqa: E402
from minipic_torch.core.config import Deck, SpeciesSpec  # noqa: E402
from minipic_torch.core.state import FieldState  # noqa: E402
from minipic_torch.ops import diag  # noqa: E402
from minipic_torch.simulation import Simulation, weight_checks  # noqa: E402
from minipic_torch.testing import diag_species  # noqa: E402

DTYPES = {"f32": torch.float32, "f64": torch.float64}


def _fields(dtype, ny=12, nx=20, seed=5):
    gen = torch.Generator().manual_seed(seed)
    return FieldState(*(torch.randn((ny, nx), generator=gen,
                                    dtype=torch.float64).to(dtype)
                        for _ in range(6)))


def _live_before(states):
    """The step's live count as it was written before the census."""
    live = torch.zeros((), dtype=torch.int32)
    for p in states:
        live = live + (p.w > 0).sum(dtype=torch.int32)
    return live.reshape(1)


def _violations_before(checks, states):
    """The step's uniform-weight guard as it was written before the
    census (``int8_weight_violations``)."""
    bad = torch.zeros((), dtype=torch.int32)
    for check, p in zip(checks, states):
        if not check:
            continue
        wmax = p.w.max()
        inf = torch.full_like(p.w, float("inf"))
        wmin = torch.where(p.w > 0, p.w, inf).min()
        bad = bad + ((wmin != wmax) & torch.isfinite(wmin)).to(torch.int32)
    return bad


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape, (a, b)
    assert torch.equal(a, b), (a, b)


@pytest.mark.parametrize("layout", ["tails", "holes", "dead"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_moments_equal_the_plain_energy_and_momentum(dtype, layout):
    p = diag_species(6, 1021, layout=layout, dtype=DTYPES[dtype], seed=3)
    ke, mom = diag.moments(p, 1836.0)
    _same(ke, cs.kinetic_energy_plain(p, 1836.0))
    _same(mom, cs.momentum_sum_plain(p, 1836.0))
    # Into rows of the step's [n_species] and [n_species, 3] outputs.
    kes = torch.full((2,), -1.0, dtype=torch.float64)
    moms = torch.full((2, 3), -1.0, dtype=torch.float64)
    got = diag.moments(p, 1836.0, (kes[1], moms[1]))
    assert got[0].data_ptr() == kes[1].data_ptr()
    _same(kes[1], ke)
    _same(moms[1], mom)
    assert float(kes[0]) == -1.0 and bool((moms[0] == -1.0).all())
    if layout == "dead":
        assert float(ke) == 0.0 and not bool(mom.any())


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_state_functions_on_the_cpu_are_the_plain_ones(dtype):
    p = diag_species(4, 512, layout="holes", dtype=DTYPES[dtype], seed=8)
    f = _fields(DTYPES[dtype])
    _same(cs.kinetic_energy(p, 2.0), cs.kinetic_energy_plain(p, 2.0))
    _same(cs.momentum_sum(p, 2.0), cs.momentum_sum_plain(p, 2.0))
    _same(cs.field_energy(f, 0.1, 0.2), cs.field_energy_plain(f, 0.1, 0.2))


_CENSUS = {
    # species (layout, uneven) and whether the guard checks each
    "uniform": ([("tails", False), ("holes", False)], (True, True)),
    "uneven": ([("tails", False), ("holes", True)], (True, True)),
    "unchecked": ([("holes", True), ("tails", True)], (False, True)),
    "empty": ([("dead", False), ("holes", True)], (True, False)),
    "no_species": ([], ()),
}


@pytest.mark.parametrize("case", list(_CENSUS))
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_census_equals_the_live_count_guard_and_field_energy(dtype, case):
    specs, checks = _CENSUS[case]
    states = [diag_species(5, 700, layout=lay, uneven=uneven,
                           dtype=DTYPES[dtype], seed=11 + i)
              for i, (lay, uneven) in enumerate(specs)]
    f = _fields(DTYPES[dtype])
    c = diag.census(states, checks, f, 0.1, 0.2, "cpu")
    _same(c.live, _live_before(states))
    _same(c.nonuniform, _violations_before(checks, states))
    _same(c.field_energy, cs.field_energy_plain(f, 0.1, 0.2))
    want_bad = {"uniform": 0, "uneven": 1, "unchecked": 1, "empty": 0,
                "no_species": 0}[case]
    assert int(c.nonuniform) == want_bad
    # Without fields: no energy; a strided block of the fields (a shard's
    # interior) sums as its copy does.
    assert diag.census(states, checks).field_energy is None
    inner = FieldState(*(a[2:-2, 3:-3] for a in f))
    _same(diag.census(states, checks, inner, 0.1, 0.2, "cpu").field_energy,
          cs.field_energy_plain(FieldState(*(a.contiguous() for a in inner)),
                                0.1, 0.2))


def _two_species_deck(deposit):
    return Deck(box_x=3.2, box_y=3.2, nx=32, ny=32, tile_nx=8, tile_ny=8,
                guard=4, species=(
                    SpeciesSpec("ele", charge=-1.0, mass=1.0, ppc=4,
                                uth=0.1, shape_order=2),
                    SpeciesSpec("ion", charge=1.0, mass=100.0, ppc=4,
                                uth=0.01, shape_order=2)),
                precision="f32", capacity_headroom=1.1, kchunk=0,
                deposit=deposit, rebin_mode="sort")


@pytest.mark.parametrize("deposit,checked", [("int8", (True, True)),
                                             ("highest", (False, False))])
def test_step_diag_keeps_its_fields_shapes_and_types(deposit, checked):
    deck = _two_species_deck(deposit)
    assert weight_checks(deck) == checked
    sim = Simulation(deck, seed=2, device="cpu")
    d = sim.step()
    assert d.field_energy.dtype == torch.float64 and d.field_energy.dim() == 0
    assert d.kinetic_energy.dtype == torch.float64
    assert tuple(d.kinetic_energy.shape) == (2,)
    assert d.momentum.dtype == torch.float64
    assert tuple(d.momentum.shape) == (2, 3)
    assert d.shard_live.dtype == torch.int32
    assert tuple(d.shard_live.shape) == (1,)
    assert d.weight_nonuniform.dtype == torch.int32
    assert d.weight_nonuniform.dim() == 0 and int(d.weight_nonuniform) == 0
    _same(d.shard_live, _live_before(sim.state.species))
    _same(d.field_energy, cs.field_energy_plain(sim.state.fields, deck.dx,
                                                deck.dy))
    assert bool((d.kinetic_energy > 0).all())
