"""The reference on hand-worked cases, the roofline's counts, and the frozen
copies of the port's decks, loader and laser."""
from __future__ import annotations

import dataclasses
import math

import pytest
import torch

from portbench import cell, inputs, roofline
from portbench.reference import step as rs

F64 = torch.float64
DECK = {"nx": 32, "ny": 32, "box_x": 3.2, "box_y": 3.2, "tile_nx": 8,
        "tile_ny": 8, "guard": 4, "dt_factor": 0.5, "boundary": "periodic",
        "absorb_width": 16}


def _one(x, y, px, py, pz, w=0.5, tile=9):
    return rs.Flat(torch.tensor([tile]), *(torch.tensor([v], dtype=F64)
                                           for v in (x, y, px, py, pz, w)))


def _uniform(**comps):
    return tuple(torch.full((32, 32), comps.get(n, 0.0), dtype=F64)
                 for n in inputs.FIELD_NAMES)


@pytest.mark.parametrize("order", [1, 2])
def test_boris_rotation_in_a_uniform_magnetic_field(order):
    geo = rs.geometry(DECK)
    b0, q, m = 2.0, -1.0, 1.0
    p0 = (0.3, -0.2, 0.1)
    new, _, _ = rs.advance(_one(12.3, 17.6, *p0), _uniform(bz=b0),
                           {"charge": q, "mass": m, "shape_order": order},
                           geo, False, F64)
    gamma = math.sqrt(1 + sum(v * v for v in p0))
    t = (q / m) * geo.dt / 2 * b0 / gamma
    theta = -2 * math.atan(t)  # Boris: rotation by 2 atan(t) about -B
    c, s = math.cos(theta), math.sin(theta)
    want = (c * p0[0] - s * p0[1], s * p0[0] + c * p0[1], p0[2])
    got = (float(new.px), float(new.py), float(new.pz))
    assert got == pytest.approx(want, abs=1e-13)


def test_uniform_electric_field_kicks_by_q_e_dt():
    geo = rs.geometry(DECK)
    new, _, _ = rs.advance(_one(12.3, 17.6, 0.0, 0.0, 0.0), _uniform(ex=0.4),
                           {"charge": -1.0, "mass": 1.0, "shape_order": 2},
                           geo, False, F64)
    assert float(new.px) == pytest.approx(-0.4 * geo.dt, rel=1e-13)
    assert float(new.py) == 0.0 and float(new.pz) == 0.0


@pytest.mark.parametrize("order", [1, 2])
def test_the_deposit_conserves_charge(order):
    """(rho1 - rho0)/dt + div J = 0 on the Yee grid, to round-off."""
    geo = rs.geometry(DECK)
    p = _one(12.3, 17.6, 0.3, -0.2, 0.1)
    new, (jx, jy, _), _ = rs.advance(
        p, _uniform(), {"charge": -1.0, "mass": 1.0, "shape_order": order},
        geo, False, F64)

    def rho(x, y):
        i = torch.arange(32, dtype=F64)
        sx, sy = rs.shape_values(x - i, order), rs.shape_values(y - i, order)
        return -0.5 * sy[:, None] * sx[None, :] / (geo.dx * geo.dy)

    d_rho = (rho(new.x, new.y) - rho(p.x, p.y)) / geo.dt
    div = ((jx - torch.roll(jx, 1, 1)) / geo.dx
           + (jy - torch.roll(jy, 1, 0)) / geo.dy)
    assert float(d_rho.abs().max()) > 10.0
    assert float((d_rho + div).abs().max()) < 1e-12 * float(
        d_rho.abs().max())


def test_roofline_counts_the_headline_state():
    live = 99_876_864
    nbytes = roofline.advance_bytes(live, 512, 512, 4)
    assert nbytes == 11 * live * 4 + 9 * 512 * 512 * 4
    least = roofline.advance_least_s({2: live}, 512, 512, 4)
    assert least == pytest.approx(nbytes / 3.35e12)
    assert roofline.advance_flops({2: live}) / 67e12 < least


def _deck_fields(deck):
    return {f.name: getattr(deck, f.name) for f in dataclasses.fields(deck)
            if f.name != "species"}


def _species_equal(a, b):
    for sa, sb in zip(a.species, b.species):
        fa = {f.name: getattr(sa, f.name) for f in dataclasses.fields(sa)}
        fb = {f.name: getattr(sb, f.name) for f in dataclasses.fields(sb)}
        da, db = fa.pop("density"), fb.pop("density")
        assert fa == fb
        assert (da is None) == (db is None)
        if da is not None:
            x = torch.linspace(0, 102.4, 1001)[None, :]
            y = torch.linspace(0, 102.4, 7)[:, None]
            assert torch.equal(da(x, y), db(x, y))
    assert len(a.species) == len(b.species)


def test_the_frozen_decks_equal_the_ports():
    from minipic_torch.decks import standard
    from minipic_torch.headline import headline_deck

    for cell_name, want in (("headline-int8", headline_deck()),
                            ("laser_plasma-f32",
                             standard.laser_plasma().deck)):
        workload, config = cell.cell_files(cell_name)
        got = cell.build_deck(cell.deck_dict(config, workload))
        assert _deck_fields(got) == _deck_fields(want)
        _species_equal(got, want)


# The blob of each load_balance deck (minipic_torch/decks/standard.py) as
# configuration files name it.
BLOBS = {
    "load_balance_stress": (0.1, 4.0, 51.2, 51.2, 12.0),
    "load_balance_stress_counts": (0.1, 4.0, 51.2, 51.2, 12.0),
    "load_balance_bunching": (0.05, 4.0, 12.8, 25.6, 8.0),
}


def _blob_loads_equal(name):
    """The deck's species as configuration entries with the blob profile:
    the same densities, and the same buckets as the port's loader (weight
    or count mode) from the same generator state."""
    from minipic_torch.decks import standard
    from minipic_torch.particles.species import load_species
    from minipic_torch.simulation import bucket_capacity

    pdeck = standard.make(name, nx=64, ny=64).deck
    blob = dict(zip(("base", "amp", "x0", "y0", "radius"), BLOBS[name]),
                profile="gaussian_blob")
    deck = _deck_fields(pdeck)
    deck["species"] = [
        dict({f.name: getattr(s, f.name) for f in dataclasses.fields(s)},
             density=blob) for s in pdeck.species]
    _species_equal(cell.build_deck(deck), pdeck)
    cap = bucket_capacity(pdeck)
    for sp, spec in zip(deck["species"], pdeck.species):
        ours = inputs.load_species(sp, deck, cap,
                                   inputs.seeded_generator(7, "cpu"),
                                   torch.float32, "cpu")
        port = load_species(spec, pdeck.domain, pdeck.tiling, cap,
                            torch.Generator().manual_seed(7), torch.float32,
                            "cpu")
        # Count loading leaves lattice slots empty; weight loading none.
        lattice = ours[5][:, :spec.ppc * pdeck.tile_nx * pdeck.tile_ny]
        assert bool((lattice == 0).any()) == (spec.load_mode == "count")
        for a, b in zip(ours, port):
            assert torch.equal(a, b)


def test_the_frozen_loader_and_laser_equal_the_ports():
    """Same lattice, weights and fields as the port's own loader and laser
    init (momenta come from another stream: the same seed draws them on
    both sides of a run from the benchmark's copy); the count mode and the
    blob of the load_balance decks the same, momenta and all, from one
    generator state."""
    from minipic_torch.decks import standard
    from minipic_torch.particles.species import load_species
    from minipic_torch.simulation import bucket_capacity

    for name in BLOBS:
        _blob_loads_equal(name)

    case = standard.laser_plasma(nx=64, ny=64)
    workload, config = cell.cell_files("laser_plasma-f32")
    deck = cell.deck_dict(config, workload)
    deck.update(nx=64, ny=64, box_x=6.4, box_y=6.4)
    pdeck = dataclasses.replace(case.deck, box_x=6.4, box_y=6.4)
    cap = bucket_capacity(pdeck)
    gen = inputs.seeded_generator(1, "cpu")
    for sp, spec in zip(deck["species"], pdeck.species):
        ours = inputs.load_species(sp, deck, cap, gen, torch.float32, "cpu")
        port = load_species(spec, pdeck.domain, pdeck.tiling, cap,
                            torch.Generator().manual_seed(0), torch.float32,
                            "cpu")
        for a, b in zip(ours[:2] + ours[5:], port[:2] + port[5:]):
            assert torch.equal(a, b)
    ours = inputs.init_fields(config["fields"], deck, torch.float32, "cpu")
    port = case.init_fields(pdeck, device="cpu")
    for a, b in zip(ours, port):
        assert torch.equal(a, b)
