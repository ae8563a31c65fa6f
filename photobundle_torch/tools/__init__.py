"""Command-line tools of the port, the twins of the repository's
`tools/` scripts, each run as `python -m photobundle_torch.tools.<name>`:

  kernels      bench_warp_kernel (the store variants of
               `ops/patch_samples.warp_patches`), ablate_patch_stats
               (K1's stages, `ops/patch_ablate`)
  the solve    bench_lm_breakdown (one LM iteration per phase, and the
               profile of one body), probe_eval65k (the evaluation stage
               by stage), bench_sampling, bench_scaling
  the engine   bench_keyframes, bench_batched (core/batched.py)
  meshes       comm_model, validate_frames_sharding, demo_multiprocess,
               bench_multihost
  accuracy     verify_e2e (the command line on a synthetic sequence),
               golden_kitti (the KITTI-scale box room, `synthetic`),
               golden_aggregate, diagnose_rpe, diagnose_w5, eval_traj,
               plot_traj

Each that computes runs on the card unless given `--device cpu`, and
raises where there is none."""

from __future__ import annotations

import os
import time

import torch

# One NVIDIA H100 SXM (NVIDIA's data sheet): HBM bandwidth and the f32
# rate outside the tensor cores, the rates every bound of the port takes.
H100_BYTES_PER_S, H100_F32_FLOPS = 3.35e12, 67e12


def build_path(*parts: str) -> str:
    """A path under the repository's ignored build/ directory, where the
    tools write their datasets and outputs by default."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return os.path.join(root, "build", *parts)


def device_name(device: torch.device) -> str:
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")


def ms_per_call(run, calls: int, device: torch.device) -> float:
    """Milliseconds per call of `run`, a function that makes `calls` calls:
    one warm-up run (kernel builds included), then one timed run, by CUDA
    events on a card (host launch gaps included: a kernel shorter than its
    wrapper's host time leaves the card idle between launches) and by the
    host clock on the CPU."""
    run()
    if device.type != "cuda":
        t0 = time.perf_counter()
        run()
        return (time.perf_counter() - t0) * 1e3 / calls
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / calls


def device_us_per_call(run, calls: int, match: str | None = None):
    """Device time per call in microseconds: the self device time of the
    card's activities (kernels whose name holds `match`; all of them where
    None) in a torch.profiler trace of one run of `run` (`calls` calls),
    which excludes the host's launch gaps; None where the trace holds no
    device time. A trace may miss launches: with `match` (one such launch
    per call) the time is averaged over the launches the trace holds.
    Call it after a warm-up."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    evts = [evt for evt in prof.key_averages()
            if evt.device_type == DeviceType.CUDA
            and (match is None or match in evt.key)]
    total = sum(evt.self_device_time_total for evt in evts)
    if match is not None:
        calls = sum(evt.count for evt in evts)
    return total / calls if total > 0 else None
