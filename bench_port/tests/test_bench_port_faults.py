"""The output check fails what it must: the control (the program's
bfloat16 path, below the configurations' float32) and the timed path broken
underneath in each way a serving cell can break; and passes the program as
it is. Tiny cells on the CPU, the real limits; everything but the look for
a card runs as in a benchmark run."""

from __future__ import annotations

import pytest
import torch

from bench_port.harness.cell import run_cell
from bench_port.tests.tiny_cells import tiny_cell, tiny_root

CELLS = ["voc352-score-b128", "bdd416-clips-open"]
SEED = 2**31 + 77


def half_batch_left_out(predict):
    """Only the first half of each request is served; the rest repeat it."""
    def run(frames, val_conf):
        n = frames.shape[0]
        out = predict(frames[: (n + 1) // 2], val_conf)
        return tuple(torch.cat([t, t[: n - t.shape[0]]]) for t in out)
    return run


def keep_flipped(predict):
    """One answer altered where it is produced: a row's NMS decision."""
    def run(frames, val_conf):
        dets, keep, *rest = predict(frames, val_conf)
        keep = keep.clone()
        keep[0, 0] = ~keep[0, 0]
        return (dets, keep, *rest)
    return run


def score_altered(predict):
    """One answer altered where it is produced: a row's confidence."""
    def run(frames, val_conf):
        dets, *rest = predict(frames, val_conf)
        dets = dets.clone()
        dets[0, 0, 4] += 0.05
        return (dets, *rest)
    return run


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("tiny"))


def _run(root, name, **kw):
    return run_cell(tiny_cell(root, name), SEED, 0.3, False, torch.device("cpu"), **kw)


@pytest.mark.parametrize("name", CELLS)
def test_the_program_passes(root, name):
    res = _run(root, name)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0


@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails(root, name):
    res = _run(root, name, precision="bfloat16")
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("fault", [half_batch_left_out, keep_flipped, score_altered])
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_path_fails(root, name, fault):
    res = _run(root, name, fault=fault)
    assert not res["correct"], res["checks"]
