"""Shared fixtures of the benchmark's own tests: the cells cut to a size the
CPU runs in seconds (the program's plain versions stand in for its kernels
there)."""
from __future__ import annotations

import copy

import pytest
import torch

from portbench import cell

torch.set_num_threads(2)


def small_cell(name: str, nx: int, ppc: int = 0, steps: int = 0):
    """The cell's (workload, configuration) on an nx^2 grid of the same
    cell size, with `ppc` particles a cell and a deck of `steps` steps
    where given."""
    workload, config = cell.cell_files(name)
    config = copy.deepcopy(config)
    deck = config["deck"]
    f = nx / deck["nx"]
    deck["box_x"] *= f
    deck["box_y"] *= f
    deck["nx"] = deck["ny"] = nx
    if ppc:
        for sp in deck["species"]:
            sp["ppc"] = ppc
    if steps:
        dx = deck["box_x"] / nx
        dt = deck["dt_factor"] / (2.0 / dx ** 2) ** 0.5
        deck["sim_time"] = (steps + 0.5) * dt
    return workload, config


def load_balance_cell(layout: str, nx: int = 64, ppc: int = 16):
    """(workload, configuration) of the port's ``load_balance_stress_counts``
    deck (``minipic_torch/decks/standard.py``: the count-loaded blob on the
    2 x 4 mesh, int8) on an nx^2 grid of the same 102.4^2 box, with `ppc`
    particles a cell, run in `layout`; the workload is the headline's."""
    workload, _ = cell.cell_files("headline-int8")
    workload = dict(copy.deepcopy(workload), config="load_balance_stress_counts",
                    layout=layout)
    blob = {"profile": "gaussian_blob", "base": 0.1, "amp": 4.0, "x0": 51.2,
            "y0": 51.2, "radius": 12.0}
    species = [
        {"name": name, "charge": q, "mass": m, "ppc": ppc, "density": blob,
         "ux": 0.0, "uy": 0.0, "uz": 0.0, "uth": uth, "uth_x": None,
         "uth_y": None, "uth_z": None, "shape_order": 1,
         "load_mode": "count", "n_max": 4.1}
        for name, q, m, uth in (("ele", -1.0, 1.0, 0.05),
                                ("ion", 1.0, 1836.0, 0.0))]
    deck = {
        "box_x": 102.4, "box_y": 102.4, "nx": nx, "ny": nx, "guard": 4,
        "tile_nx": 8, "tile_ny": 8, "dt_factor": 0.5, "sim_time": 10.0,
        "save_frequency": 25, "boundary": "periodic", "absorb_width": 16,
        "moving_window": False, "mesh_shape": [2, 4], "tile_capacity": None,
        "capacity_headroom": 1.5, "rebin_interval": 1,
        "rebin_trigger": "auto", "kchunk": 0, "gather_precision": "exact",
        "rebin_mode": "auto", "mover_capacity": None,
        "exchange_capacity": None, "species": species}
    config = {"name": "load_balance_stress_counts", "reduced": [],
              "deck": deck, "fields": {"init": "zeros"}}
    return workload, config


@pytest.fixture
def headline_small():
    return small_cell("headline-int8", 32, ppc=16)


@pytest.fixture
def headline_f64_small():
    return small_cell("headline-f64", 32, ppc=16)


@pytest.fixture
def laser_small():
    return small_cell("laser_plasma-f32", 64, steps=12)


def pulse_cell(nx: int = 64):
    """``reference_pulse-f64``'s (workload, configuration) on an nx^2 grid
    of the same 10 x 10 box, as the port's ``reference_pulse(nx, nx)`` cuts
    it (16 x 16 tiles at 64^2), with a warm-up of 20 steps."""
    workload, config = cell.cell_files("reference_pulse-f64")
    config = copy.deepcopy(config)
    tile = max(t for t in range(1, 26) if nx % t == 0)
    config["deck"].update(nx=nx, ny=nx, tile_nx=tile, tile_ny=tile)
    workload = dict(copy.deepcopy(workload),
                    warmup={"steps": 20, "force_rebin": 0})
    return workload, config


# The port's laser_wakefield_window deck (minipic_torch/decks/standard.py)
# as a configuration file states it: the n = 0.3 plateau behind the ramp at
# x = 40, the a0 = 2 laser at x = 40, the window following the pulse at c.
WINDOW_DENSITY = {"profile": "tanh_ramp", "n0": 0.3, "x0": 40.0,
                  "width": 4.0}


def window_cell(nx: int = 64, ny: int = 32):
    """(workload, configuration) of the port's ``laser_wakefield_window``
    deck cut to nx x ny cells of the same 51.2 x 25.6 box, as
    ``laser_wakefield_window(nx, ny)`` cuts it; the workload judges the
    window's last step, the next step that shifts the window and the
    start, at the laser cell's limits."""
    workload, _ = cell.cell_files("laser_plasma-f32")
    workload = dict(copy.deepcopy(workload), config="laser_wakefield_window",
                    restart="none", warmup={"steps": 3, "force_rebin": 0},
                    judge=["last", "shift", "start"])
    species = [
        {"name": name, "charge": q, "mass": m, "ppc": 4,
         "density": dict(WINDOW_DENSITY), "ux": 0.0, "uy": 0.0, "uz": 0.0,
         "uth": uth, "uth_x": None, "uth_y": None, "uth_z": None,
         "shape_order": 2, "load_mode": "weight", "n_max": None}
        for name, q, m, uth in (("ele", -1.0, 1.0, 0.01),
                                ("ion", 1.0, 1836.0, 0.0))]
    deck = {
        "box_x": 51.2, "box_y": 25.6, "nx": nx, "ny": ny, "guard": 4,
        "tile_nx": 8, "tile_ny": 8, "dt_factor": 0.5, "sim_time": 200.0,
        "save_frequency": 25, "boundary": "absorbing", "absorb_width": 16,
        "moving_window": True, "mesh_shape": None, "tile_capacity": None,
        "capacity_headroom": 1.5, "rebin_interval": 1,
        "rebin_trigger": "auto", "kchunk": 0, "gather_precision": "exact",
        "rebin_mode": "auto", "mover_capacity": None,
        "exchange_capacity": None, "species": species}
    fields = {"init": "gaussian_laser_x", "a0": 2.0, "k0": 5.0,
              "x_center": 40.0, "length": 4.0, "waist": 10.0}
    config = {"name": "laser_wakefield_window", "reduced": [], "deck": deck,
              "fields": fields}
    return workload, config
