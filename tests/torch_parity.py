"""Shared helpers of the parity tests between photobundle_tpu (JAX, the
reference) and photobundle_torch (the port): inputs go to both packages as
the same numpy arrays, results come back as numpy arrays."""

import numpy as np
import torch

from photobundle_torch import convert


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
