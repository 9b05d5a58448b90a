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
