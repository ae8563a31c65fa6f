"""Bytes per LM iteration of the sharded solve, by mesh layout.

Twin of tools/comm_model.py. The sharded body (core/lm.py, ShardCtx;
parallel/sharded.py) runs these collectives per LM iteration on a
('frames' = F, 'points' = P) mesh, each one flat f32 buffer (the
per-frame observation counts travel as floats; N_loc = N / P,
W_loc = W / F):

    sum over frames   : hpp (3,3,N_loc) + bp (3,N_loc)          12 N_loc
    gather (frames)   : hcc (W_loc,6,6), bc (W_loc,6),          (43 + 18 N_loc) W
                        hpc (W_loc,3,6,N_loc) and the counts
    sum over points   : hcc, bc, the counts and the point       36 W^2 + 49 W
                        parts of S (W,W,6,6) and rhs (W,6)
    sum over both     : the candidate's cost                     1
    sum over points   : the point parts of the model decrease,   4
                        |dp|^2, |x|^2 and |bp|^2

(a points-only mesh, F = 1, has no frames collectives). The sizes are of
each collective's result on one rank; on the wire a ring all-reduce of b
bytes over n ranks sends 2 (n-1)/n b per rank and an all-gather of a b
byte result (n-1)/n b.

    python -m photobundle_torch.tools.comm_model [--points 4096] \
        [--window 5] [--link-gbps 450] [--mobs 15.6]
    python -m photobundle_torch.tools.comm_model --verify

The table's time columns are a model, not a measurement: compute at
`--mobs` million observations per second on one card (default: the
captured solve's 754-772 LM iterations/s at 4096 x 5 on one H100 at
700 W, chip_smoke.py phase 4 as PERF.md records it, times 20 480
observations) split evenly over the ranks,
and the wire bytes at `--link-gbps` (default 450 GB/s, one direction of
NVLink on an H100, NVIDIA's data sheet), with no overlap. --verify runs
the real solvers in a one-rank gloo world on the CPU, records every
collective's result bytes, and checks the body's against
`analytic_volumes` (the difference of an 8- and a 4-iteration solve).
"""

from __future__ import annotations

import argparse
import json

F32 = 4


def analytic_volumes(n_points: int, window: int, mesh_frames: int,
                     mesh_points: int, frames_layout: bool | None = None
                     ) -> dict:
    """Result bytes on one rank of each per-iteration collective; the
    frames layout's (a frames mesh, `frames_layout`, by default F > 1)
    include the frames collectives even where F = 1."""
    n_loc = n_points // mesh_points
    w = window
    out = {
        "sum_points_hcc_bc_S_rhs": (36 * w * w + 49 * w) * F32,
        "sum_obs_cost": F32,
        "sum_points_scalars": 4 * F32,
    }
    if mesh_frames > 1 if frames_layout is None else frames_layout:
        out["sum_frames_hpp_bp"] = 12 * n_loc * F32
        out["gather_frames_hcc_bc_hpc"] = (43 + 18 * n_loc) * w * F32
    return out


def wire_bytes(volumes: dict, mesh_frames: int, mesh_points: int) -> dict:
    """Bytes one rank sends per iteration, ring collectives."""
    def size(name):
        if "frames" in name:
            return mesh_frames
        return (mesh_frames * mesh_points if name.startswith("sum_obs")
                else mesh_points)

    out = {}
    for name, b in volumes.items():
        n = size(name)
        share = (n - 1) / n
        out[name] = (share * b if name.startswith("gather")
                     else 2 * share * b)
    return out


def predict(n_points, window, mesh_frames, mesh_points, link_gbps, mobs):
    ranks = mesh_frames * mesh_points
    obs = n_points * window
    compute_ms = obs / (mobs * 1e6) / ranks * 1e3
    vols = analytic_volumes(n_points, window, mesh_frames, mesh_points)
    wire = sum(wire_bytes(vols, mesh_frames, mesh_points).values())
    comm_ms = wire / (link_gbps * 1e9) * 1e3
    return {
        "points": n_points, "window": window,
        "mesh": f"{mesh_frames}x{mesh_points}", "ranks": ranks,
        "result_bytes_per_iter": sum(vols.values()),
        "wire_bytes_per_iter": round(wire, 1),
        "model_compute_ms_per_iter": round(compute_ms, 4),
        "model_comm_ms_per_iter": round(comm_ms, 5),
        "model_efficiency": round(compute_ms / (compute_ms + comm_ms), 4),
    }


def measured_body_bytes(layout: str, n_points: int = 64, window: int = 4):
    """Result bytes per body of the real solver's collectives in the
    initialized one-rank world: the recorded bytes of an 8-iteration
    solve less those of a 4-iteration one, over 4. layout: 'points' or
    'frames'."""
    from .. import entry
    from ..parallel import make_mesh, sharded

    cam, offsets, args = entry.make_problem(n_points, window, 32, 48, 1,
                                            seed=0)
    seen = []
    apply = sharded.Collective.apply

    def recording(self, *tensors):
        out = apply(self, *tensors)
        seen.append(sum(t.numel() * t.element_size() for t in out))
        return out

    kw = dict(huber_delta=1e9, function_tolerance=0.0,
              parameter_tolerance=0.0)
    totals = []
    sharded.Collective.apply = recording
    try:
        for iters in (4, 8):
            if layout == "points":
                solve = sharded.ShardedLMSolver(
                    make_mesh(points=1), cam, offsets, n_points=n_points,
                    max_iterations=iters, **kw)
            else:
                solve = sharded.make_frames_sharded_solver(
                    sharded.make_frames_mesh(frames=1, points=1), cam,
                    offsets, n_points=n_points, window_size=window,
                    max_iterations=iters, **kw)
            seen.clear()
            solve(*args)
            totals.append(sum(seen))
    finally:
        sharded.Collective.apply = apply
    return (totals[1] - totals[0]) / 4


def verify() -> int:
    """The recorded body bytes against the model, points and frames
    layouts, in a one-rank gloo world on the CPU."""
    import socket

    import torch.distributed as dist

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0)
    try:
        ok = check()
    finally:
        dist.destroy_process_group()
    return 0 if ok else 1


def check(n_points: int = 64, window: int = 4) -> bool:
    """`verify` in the world already initialized (one rank)."""
    ok = True
    for layout in ("points", "frames"):
        got = measured_body_bytes(layout, n_points, window)
        want = sum(analytic_volumes(n_points, window, 1, 1,
                                    layout == "frames").values())
        print(f"{layout}: recorded {got:.0f} B per body, model {want} B "
              f"{'OK' if got == want else 'MISMATCH'}")
        ok &= got == want
    print("COMM MODEL VERIFY", "OK" if ok else "FAILED")
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--verify", action="store_true")
    ap.add_argument("--points", type=int, default=4096)
    ap.add_argument("--window", type=int, default=5)
    ap.add_argument("--link-gbps", type=float, default=450.0)
    ap.add_argument("--mobs", type=float, default=15.6)
    args = ap.parse_args(argv)
    if args.verify:
        return verify()
    n, w = args.points, args.window
    layouts = [(1, 2), (1, 4), (1, 8)]
    layouts += [(f, p) for f, p in ((w, 1), (w, 2)) if w % f == 0 and f > 1]
    for f, p in layouts:
        if n % p == 0:
            print(json.dumps(predict(n, w, f, p, args.link_gbps, args.mobs)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
