"""The port's multi-sequence refinement and its elastic scheduler.

- Twins of tests/test_scheduler.py on photobundle_torch/parallel/scheduler
  (the port's copy of the host-only scheduler): claiming, stealing,
  heartbeats, idempotent completion.
- `make_units` against the JAX package's, case by case.
- Twins of tests/test_multi.py on `python -m photobundle_torch.multi`
  with `--device cpu`: inline, chunked with a merge, and two spawned
  worker processes; and two workers writing the same merged trajectory,
  byte for byte, as one.
"""

import os
import time

import pytest

from photobundle_torch import multi as multi_mod
from photobundle_torch.io import trajectory as traj_mod
from photobundle_torch.parallel.scheduler import (LeaseScheduler, WorkUnit,
                                                  make_units)

from synthetic import drift_poses, write_kitti_dataset
from torch_parity import few_threads  # noqa: F401  (module fixture)


def test_make_units_whole_sequences():
    units = make_units([0, 3, 7])
    assert [u.sequence for u in units] == [0, 3, 7]
    assert all(u.num_frames == -1 for u in units)
    assert [u.uid for u in units] == [0, 1, 2]


def test_make_units_chunked():
    units = make_units([0], frames_per_unit=100, sequence_lengths={0: 250})
    assert [(u.first_frame, u.num_frames) for u in units] == [
        (0, 100), (100, 100), (200, 50)]


def test_make_units_folds_short_tail():
    units = make_units([0], frames_per_unit=100, sequence_lengths={0: 203},
                       min_frames=5)
    assert [(u.first_frame, u.num_frames) for u in units] == [
        (0, 100), (100, 103)]
    units = make_units([0], frames_per_unit=100, sequence_lengths={0: 205},
                       min_frames=5)
    assert [(u.first_frame, u.num_frames) for u in units] == [
        (0, 100), (100, 100), (200, 5)]
    units = make_units([0], frames_per_unit=100, sequence_lengths={0: 3},
                       min_frames=5)
    assert [(u.first_frame, u.num_frames) for u in units] == [(0, 3)]


UNIT_CASES = {   # name -> make_units arguments
    "whole": (([0, 3, 7],), {}),
    "chunked": (([0, 2],), dict(frames_per_unit=100,
                                sequence_lengths={0: 250, 2: 99})),
    "short tail": (([0],), dict(frames_per_unit=100,
                                sequence_lengths={0: 203}, min_frames=5)),
    "tail kept": (([0, 1],), dict(frames_per_unit=6,
                                  sequence_lengths={0: 12, 1: 17},
                                  min_frames=4)),
    "short sequence": (([5],), dict(frames_per_unit=100,
                                    sequence_lengths={5: 3}, min_frames=5)),
    "no lengths": (([1, 2],), dict(frames_per_unit=10)),
}


@pytest.mark.parametrize("case", sorted(UNIT_CASES))
def test_make_units_matches_jax(case):
    """The port's copy cuts the same units as the JAX package's."""
    from photobundle_tpu.parallel import scheduler as jsched

    args, kw = UNIT_CASES[case]
    want = [(u.uid, u.sequence, u.first_frame, u.num_frames)
            for u in jsched.make_units(*args, **kw)]
    got = [(u.uid, u.sequence, u.first_frame, u.num_frames)
           for u in make_units(*args, **kw)]
    assert got == want
    assert all(WorkUnit.from_json(u.to_json()) == u
               for u in make_units(*args, **kw))


def test_disjoint_claims_two_workers(tmp_path):
    root = str(tmp_path)
    a = LeaseScheduler(root, "a")
    b = LeaseScheduler(root, "b")
    units = make_units([0, 1, 2, 3])
    a.publish(units)
    b.publish(units)  # idempotent

    claimed = {"a": [], "b": []}
    ita, itb = a.claims(), b.claims()
    ua = next(ita)
    ub = next(itb)
    assert ua.uid != ub.uid
    claimed["a"].append(ua)
    claimed["b"].append(ub)
    a.complete(ua)
    b.complete(ub)
    for w, sched, it in (("a", a, ita), ("b", b, itb)):
        for u in it:
            claimed[w].append(u)
            sched.complete(u)
    uids = sorted(u.uid for w in claimed.values() for u in w)
    assert uids == [0, 1, 2, 3]  # each unit exactly once


def test_steal_from_dead_worker(tmp_path):
    root = str(tmp_path)
    # auto_heartbeat=False models a crashed process: its heartbeat thread
    # dies with it, so the lease goes stale.
    dead = LeaseScheduler(root, "dead", lease_timeout_s=0.2,
                          auto_heartbeat=False)
    live = LeaseScheduler(root, "live", lease_timeout_s=0.2)
    dead.publish(make_units([0]))
    it = dead.claims()
    u = next(it)           # dead claims unit 0 and then never heartbeats
    assert u.uid == 0
    time.sleep(0.25)       # lease expires
    got = []
    for v in live.claims():
        got.append(v)
        live.complete(v)
    assert [v.uid for v in got] == [0]
    assert os.path.exists(os.path.join(root, "unit_00000.done"))


def test_heartbeat_prevents_steal(tmp_path):
    root = str(tmp_path)
    w1 = LeaseScheduler(root, "w1", lease_timeout_s=0.4)
    w2 = LeaseScheduler(root, "w2", lease_timeout_s=0.4)
    w1.publish(make_units([0]))
    it = w1.claims()
    u = next(it)
    for _ in range(3):
        time.sleep(0.15)
        w1.heartbeat()
        assert not w2._try_claim(u)
    w1.complete(u)
    assert w2.pending() == []


def test_auto_heartbeat_protects_slow_worker(tmp_path):
    """A live worker stuck in a long operation (a first window's kernel
    builds and graph captures) keeps its unit: the timer thread
    heartbeats independently of work progress."""
    root = str(tmp_path)
    slow = LeaseScheduler(root, "slow", lease_timeout_s=0.4)
    thief = LeaseScheduler(root, "thief", lease_timeout_s=0.4)
    slow.publish(make_units([0]))
    it = slow.claims()
    u = next(it)
    deadline = time.time() + 1.5
    while time.time() < deadline:
        time.sleep(0.1)
        assert not thief._try_claim(u), "live worker's unit was stolen"
    slow.complete(u)
    assert thief.pending() == []


def test_release_requeues(tmp_path):
    root = str(tmp_path)
    w1 = LeaseScheduler(root, "w1")
    w2 = LeaseScheduler(root, "w2")
    w1.publish(make_units([0, 1]))
    it = w1.claims()
    u = next(it)
    w1.release(u)  # graceful handback
    got = []
    for v in w2.claims():
        got.append(v.uid)
        w2.complete(v)
    assert sorted(got) == [0, 1]


# ---------------------------------------------------------------------------
# python -m photobundle_torch.multi (tests/test_multi.py's dataset and
# configuration)


def _make_dataset(tmp_path, rng, seqs, n_frames=8):
    root = str(tmp_path / "kitti")
    gts = {}
    for s in seqs:
        gt, _ = write_kitti_dataset(root, s, rng, n_frames=n_frames,
                                    shape=(64, 96))
        gts[s] = gt
        vo = drift_poses(rng, gt, trans_sigma=0.003, rot_sigma=0.0008)
        with open(os.path.join(root, "poses", f"{s:02d}.txt"), "w") as f:
            for p in vo:
                f.write(" ".join(f"{v:.9f}" for v in p[:3].reshape(-1))
                        + "\n")
    return root, gts


def _write_cfg(tmp_path, root):
    cfgp = str(tmp_path / "multi.cfg")
    with open(cfgp, "w") as f:
        f.write(f"""dataDir = {root}
descriptor = Intensity
patchRadius = 1
slidingWindowSize = 4
maxNumPoints = 256
maxPointsPerFrame = 64
maxIterations = 10
pyramidLevels = 1
numDisparities = 32
minDepth = 0.5
maxDepth = 60.0
""")
    return cfgp


def _done(outdir):
    sched = os.path.join(outdir, ".sched")
    return len([f for f in os.listdir(sched) if f.endswith(".done")])


def test_multi_sequence_inline(tmp_path, rng):
    root, gts = _make_dataset(tmp_path, rng, [0, 1], n_frames=6)
    cfgp = _write_cfg(tmp_path, root)
    outdir = str(tmp_path / "out")
    rc = multi_mod.main(["--config", cfgp, "--sequences", "0,1",
                         "--output-dir", outdir, "--workers", "1",
                         "--device", "cpu"])
    assert rc == 0
    for s in (0, 1):
        t = traj_mod.load_poses_kitti(os.path.join(outdir, f"{s:02d}.txt"))
        assert len(t) == len(gts[s])
    assert _done(outdir) == 2


def test_multi_sequence_chunked_merge(tmp_path, rng):
    root, gts = _make_dataset(tmp_path, rng, [0], n_frames=12)
    cfgp = _write_cfg(tmp_path, root)
    outdir = str(tmp_path / "out")
    rc = multi_mod.main(["--config", cfgp, "--sequences", "0",
                         "--output-dir", outdir, "--workers", "1",
                         "--frames-per-unit", "6", "--device", "cpu"])
    assert rc == 0
    merged = traj_mod.load_poses_kitti(os.path.join(outdir, "00.txt"))
    assert len(merged) == 12
    assert _done(outdir) == 2


def test_multi_sequence_spawned_workers(tmp_path, rng):
    """Two spawned worker processes (`python -m photobundle_torch.multi`)
    share the elastic scheduler and refine disjoint units; the merged
    trajectory is byte for byte that of one inline worker on the same
    units."""
    root, gts = _make_dataset(tmp_path, rng, [0], n_frames=12)
    cfgp = _write_cfg(tmp_path, root)
    outs = {}
    for workers in (2, 1):
        outdir = str(tmp_path / f"out{workers}")
        rc = multi_mod.main(["--config", cfgp, "--sequences", "0",
                             "--output-dir", outdir, "--workers",
                             str(workers), "--frames-per-unit", "6",
                             "--device", "cpu"])
        assert rc == 0
        assert _done(outdir) == 2
        with open(os.path.join(outdir, "00.txt"), "rb") as f:
            outs[workers] = f.read()
    assert outs[2] == outs[1]
    assert len(traj_mod.load_poses_kitti(
        os.path.join(str(tmp_path / "out2"), "00.txt"))) == 12


def test_multi_refuses_a_card_it_does_not_have(tmp_path, monkeypatch):
    """The workers run on the card by default; without one `multi.main`
    raises before it publishes any unit."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    outdir = str(tmp_path / "out")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        multi_mod.main(["--config", "unused.cfg", "--sequences", "0",
                        "--output-dir", outdir])
    assert not os.path.exists(outdir)
