"""The comparison that decides ``correct``, run at sizes a CPU test run
holds: a sound run passes its cell's limits; the control (the plain
reference one precision step lower, in the program's place) and each
planted fault of the timed path fail them."""
from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from portbench import calibrate, harness
from portbench.tests.small import small_cell

SEED = 2_600_000_123


def run_cell(cell, seconds: float = 0.05) -> bool:
    out = harness.generator(cell).run(cell, SEED, seconds, False,
                                   torch.device("cpu"), time.perf_counter())
    correct, checks = harness.judge(out["values"], cell.limits)
    print(checks)
    return correct


@pytest.fixture
def map_cell():
    return small_cell("map.replica_room0", 0.1)


@pytest.fixture
def loc_cell():
    return small_cell("localize.replica_room0", 0.25)


def test_sound_mapping_run_is_correct(map_cell):
    assert run_cell(map_cell)


def test_sound_localize_run_is_correct(loc_cell):
    assert run_cell(loc_cell, 1.0)


def _wrap_step(monkeypatch, wrap):
    from splatloc_tpu_torch.train import mapping
    real = mapping.make_mapping_step
    monkeypatch.setattr(mapping, "make_mapping_step",
                        lambda cfg: wrap(real(cfg)))


def test_step_that_returns_its_state_unchanged_fails(map_cell, monkeypatch):
    def wrap(step):
        def fn(scene, opt, stats, frames, it):
            _, _, stats, loss, vis, drop = step(scene, opt, stats, frames,
                                                it)
            return scene, opt, stats, loss, vis, drop
        return fn
    _wrap_step(monkeypatch, wrap)
    assert not run_cell(map_cell)


def test_step_that_leaves_half_the_window_out_fails(map_cell, monkeypatch):
    def wrap(step):
        def fn(scene, opt, stats, frames, it):
            V = frames["w2c"].shape[0]
            keep = V - V // 2
            cut = {k: torch.cat([v[:keep], v[:V - keep]])
                   for k, v in frames.items()}
            return step(scene, opt, stats, cut, it)
        return fn
    _wrap_step(monkeypatch, wrap)
    assert not run_cell(map_cell)


def test_pose_altered_where_it_is_produced_fails(loc_cell, monkeypatch):
    from splatloc_tpu_torch.match import pnp
    real = pnp.solve_pnp_ransac

    def altered(*a, **kw):
        out = real(*a, **kw)
        if out["success"]:
            out = dict(out, t=out["t"] + 0.01)
        return out
    monkeypatch.setattr(pnp, "solve_pnp_ransac", altered)
    assert not run_cell(loc_cell, 1.0)


def test_matches_altered_where_they_are_made_fails(loc_cell, monkeypatch):
    from splatloc_tpu_torch.match import hungarian
    real = hungarian.hungarian_solve

    def altered(*a, **kw):
        matches, sims = real(*a, **kw)
        matches = matches.copy()
        matches[0, ::2] = np.roll(matches[0, ::2], 1)
        return matches, sims
    monkeypatch.setattr(hungarian, "hungarian_solve", altered)
    assert not run_cell(loc_cell, 1.0)


@pytest.mark.parametrize("name,scale", [("map.replica_room0", 0.1),
                                        ("localize.replica_room0", 0.25)])
def test_control_fails(name, scale):
    cell = small_cell(name, scale)
    r = calibrate.readings(cell, SEED, torch.device("cpu"))
    assert harness.judge(r["program"], cell.limits)[0]
    assert not harness.judge(r["control"], cell.limits)[0]
