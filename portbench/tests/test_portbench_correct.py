"""``correct`` on the CPU at sizes a test run holds: a sound run passes;
the control (the reference in the next precision below the
configuration's, in the program's place) fails; and the whole run, the
harness's look for a card skipped, comes out not correct with the timed
path broken underneath, once for each fault the cell can have (a stream
step that returns its state unchanged; half of a call's fields left out,
the rest repeated; an answer altered where it is produced).  No cell runs
across cards, so no exchange between them can be left out."""
import importlib
import json
import pathlib

import pytest
import torch

from portbench import harness

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CPU = torch.device("cpu")
SEED = 2 ** 31 + 101
TINY = {"farneback.clip720p_t7": {"height": 72, "width": 96, "pool": 10},
        "farneback.clip1080p_2cam": {"height": 64, "width": 96, "pool": 10},
        "pwcnet.batch8_480p": {"height": 64, "width": 64, "pool": 10, "batch": 3},
        "pwcnet.stream_480p": {"height": 64, "width": 64, "pool": 10,
                               "check_calls": 6}}


def _spec(cell):
    spec = harness.cell_spec(BENCH, cell)
    spec["traffic"].update(TINY[cell], check_calls=TINY[cell].get("check_calls", 2))
    return spec


def _system(spec):
    return importlib.import_module(
        f"portbench.systems.{spec['config']['system']}").System(spec["config"], CPU)


def _run(spec, system, seconds=0.3):
    return harness.run_cell(spec, SEED, seconds, False, CPU, system=system)


@pytest.mark.parametrize("cell", sorted(TINY))
def test_a_sound_run_is_correct(cell):
    spec = _spec(cell)
    r = _run(spec, _system(spec))
    assert r["correct"], r["checks"]


@pytest.mark.parametrize("cell", sorted(TINY))
def test_the_control_is_not_correct(cell):
    spec = _spec(cell)
    system = _system(spec)
    system.use_control()
    r = _run(spec, system)
    assert not r["correct"], r["checks"]


def _half_left_out(fn):
    def broken(*args):
        out = fn(*args).clone()
        n = out.shape[0]
        out[n // 2:] = out[:n - n // 2].clone()
        return out
    return broken


def _altered(fn):
    def broken(*args):
        out = fn(*args).clone()
        out[0, ..., 0] += 0.1
        return out
    return broken


def _stale_state(system):
    make = system.stream_backend

    def backend_factory():
        backend = make()
        stream = backend.stream
        advance = stream._advance

        def stuck(frame, mask):
            keep = stream._prev
            du = advance(frame, mask)
            stream._prev = keep
            return du

        stream._advance = stuck
        return backend
    system.stream_backend = backend_factory


def _altered_du(system):
    make = system.stream_backend

    def backend_factory():
        backend = make()

        def broken(prev, cur, dt):
            return backend(prev, cur, dt) + 0.01
        broken.stream = backend.stream
        return broken
    system.stream_backend = backend_factory


def _entry(system):
    return "clip" if hasattr(system, "clip") else "pairs"


def _patch(fault):
    def apply(system):
        name = _entry(system)
        setattr(system, name, fault(getattr(system, name)))
    return apply


FAULTS = [("farneback.clip720p_t7", "half_left_out", _patch(_half_left_out)),
          ("farneback.clip720p_t7", "answer_altered", _patch(_altered)),
          ("farneback.clip1080p_2cam", "half_left_out", _patch(_half_left_out)),
          ("farneback.clip1080p_2cam", "answer_altered", _patch(_altered)),
          ("pwcnet.batch8_480p", "half_left_out", _patch(_half_left_out)),
          ("pwcnet.batch8_480p", "answer_altered", _patch(_altered)),
          ("pwcnet.stream_480p", "state_unchanged", _stale_state),
          ("pwcnet.stream_480p", "answer_altered", _altered_du)]


@pytest.mark.parametrize("cell,name,fault", FAULTS, ids=[f"{c}-{n}" for c, n, _ in FAULTS])
def test_a_broken_timed_path_is_not_correct(cell, name, fault):
    spec = _spec(cell)
    system = _system(spec)
    fault(system)
    r = _run(spec, system)
    assert not r["correct"], r["checks"]
