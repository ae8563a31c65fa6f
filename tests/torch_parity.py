"""Shared helpers of the parity tests between photobundle_tpu (JAX, the
reference) and photobundle_torch (the port): inputs go to both packages as
the same numpy arrays, results come back as numpy arrays."""

import numpy as np
import pytest
import torch

from photobundle_torch import convert


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads for a module's small CPU solves (a test module
    that imports this fixture uses it): the test workers share the host's
    cores, and oversubscribed thread pools made such runs several times
    slower than with two."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(2, threads))
    yield
    torch.set_num_threads(threads)


def port_problem(problem, device="cpu"):
    """tests/test_residuals.setup_problem's tuple -> the port's, same order:
    (cam, t_wc, x_world, patch, channels, grads, obs, offsets)."""
    cam, t_wc, x, patch, ch, g, obs, off = problem
    cam_t, off_t, arrays = convert.problem_from_numpy(
        cam, off, (t_wc, x, patch, ch, g, obs), device=device)
    return (cam_t, *arrays, off_t)


def to_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_fields_close(out, ref, fields, atol, rtol, equal_nan=False):
    """Compare the named fields of two NamedTuples (port vs JAX)."""
    for name in fields:
        np.testing.assert_allclose(to_np(getattr(out, name)),
                                   to_np(getattr(ref, name)), atol=atol,
                                   rtol=rtol, equal_nan=equal_nan,
                                   err_msg=name)


def port_camera(cam, device="cpu"):
    """A JAX package Camera -> the port's."""
    from photobundle_torch.geometry.camera import Camera
    return Camera.create(*(float(v) for v in cam), device=device)


def port_config(cfg):
    """A JAX package PBAConfig -> the port's, same field values (the JAX
    backend names 'xla' / 'pallas' map to the port's 'auto')."""
    import dataclasses

    from photobundle_torch.config import PBAConfig
    kw = dataclasses.asdict(cfg)
    kw["solverBackend"] = "auto"
    return PBAConfig(**kw)


def state_np(points, window):
    """An engine's (PointTable, Window), either package's -> numpy."""
    return (type(points)(*(to_np(a).copy() for a in points)),
            type(window)(*(to_np(a).copy() for a in window)))


class EngineTrace:
    """Drives the JAX package's engine through `add_frame` and records, as
    numpy, what its two device programs saw and returned: for every frame
    the ingest's arguments and its state before and after; for every
    window solve its state before and after and its LMStats. A port step
    can then start from the reference engine's exact state."""

    def __init__(self, pba):
        self.ingests, self.solves = [], []
        ingest, optimize = pba._ingest, pba._optimize

        def traced_ingest(window, points, *args):
            before = state_np(points, window)
            host_args = [to_np(a) for a in args]
            window, points, diag = ingest(window, points, *args)
            self.ingests.append(dict(before=before, args=host_args,
                                     after=state_np(points, window)))
            return window, points, diag

        def traced_optimize(window, points):
            before = state_np(points, window)
            window, points, stats, pv = optimize(window, points)
            self.solves.append(dict(
                before=before, after=state_np(points, window),
                stats=type(stats)(*(to_np(a).copy() for a in stats)),
                point_valid=to_np(pv).copy()))
            return window, points, stats, pv

        pba._ingest = traced_ingest
        pba._optimize = traced_optimize
