"""The port's stage merge against the JAX package's.

On the CPU the port runs the plain version (``kernels.ref.stage_merge_ref``,
through ``kernels.ops.stage_merge`` for a whole stage); it is held against
the Pallas kernel in interpret mode over tests/test_kernels.py's sweep
(fp32 2e-5, bf16 3e-2), the weight extremes (1e-6) and convexity.  The CUDA
kernel is held against the plain version on the card in
tests/test_torch_gpu.py and chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.stage_merge import stage_merge as jax_stage_merge
from repro_torch.kernels import ops
from repro_torch.kernels import ref as TR
from repro_torch.kernels import stage_merge as SM

TOL = {"float32": dict(atol=2e-5, rtol=2e-5),
       "bfloat16": dict(atol=3e-2, rtol=3e-2)}


def pair(seed, shape):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


@pytest.mark.parametrize("shape", [(5,), (8, 1024), (3, 65, 33), (8193,),
                                   (2, 4, 8, 16)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_merge_matches_pallas(shape, dtype):
    x, y = pair(0, shape)
    want = jax_stage_merge(jnp.asarray(x).astype(dtype),
                           jnp.asarray(y).astype(dtype), 0.25, 0.75,
                           interpret=True)
    tx, ty = (torch.from_numpy(a).to(getattr(torch, dtype)) for a in (x, y))
    got = TR.stage_merge_ref(tx, ty, 0.25, 0.75)
    assert got.shape == shape and got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL[dtype])


@pytest.mark.parametrize("ca,cb", [(1.0, 0.0), (0.0, 1.0), (0.5, 0.5),
                                   (0.9999, 0.0001)])
def test_plain_merge_weight_extremes(ca, cb):
    x, y = pair(1, (4, 130))
    want = jax_stage_merge(jnp.asarray(x), jnp.asarray(y), ca, cb,
                           interpret=True)
    got = TR.stage_merge_ref(torch.from_numpy(x), torch.from_numpy(y), ca, cb)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    np.testing.assert_allclose(got.numpy(), ca * x + cb * y, atol=1e-6)


def test_plain_merge_is_convex():
    x, y = pair(2, (64, 64))
    got = TR.stage_merge_ref(torch.from_numpy(x), torch.from_numpy(y), 0.3, 0.7)
    assert (got.numpy() >= np.minimum(x, y) - 1e-6).all()
    assert (got.numpy() <= np.maximum(x, y) + 1e-6).all()


def test_ops_merges_a_stage_into_tower_slices_on_cpu():
    """The recovery path on the CPU: every leaf of a stage, from slices of
    stacked leaves into the failed stage's slices, with 0-d tensor weights."""
    rng = np.random.default_rng(3)
    towers = [torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
              for sh in ((6, 8, 16), (6, 8))]
    ca, cb = torch.tensor(0.4), torch.tensor(0.6)
    want = [0.4 * t[0:2] + 0.6 * t[4:6] for t in towers]
    out = ops.stage_merge([t[0:2] for t in towers], [t[4:6] for t in towers],
                          ca, cb, out=[t[2:4] for t in towers])
    for t, o, w in zip(towers, out, want):
        assert o.data_ptr() == t[2:4].data_ptr()
        torch.testing.assert_close(t[2:4], w, atol=1e-6, rtol=1e-6)
    fresh = ops.stage_merge([towers[0][0:2]], [towers[0][4:6]], 1.0, 0.0)
    torch.testing.assert_close(fresh[0], towers[0][0:2])


def test_merge_kernel_wrapper_refuses_cpu_tensors():
    x = torch.zeros(8)
    before = SM.launches
    with pytest.raises(ValueError, match="CUDA"):
        SM.stage_merge([x], [x.clone()], [x.clone()], torch.zeros(2))
    assert SM.launches == before


def test_ops_merge_raises_off_cpu_and_cuda():
    """Another device raises; meta takes the kernel's meta branch."""
    x = torch.empty(8).as_subclass(_Elsewhere)
    with pytest.raises(ValueError, match="xpu"):
        ops.stage_merge([x], [x], 0.5, 0.5)
    x = torch.empty(8, device="meta")
    before = ops.launch_counts()
    assert ops.stage_merge([x], [x], 0.5, 0.5)[0].shape == x.shape
    assert ops.launch_counts() == before


class _Elsewhere(torch.Tensor):
    """A CPU tensor that reports another device, ``xpu``, for which the port
    has no kernel and no plain version."""

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        if getattr(func, "__self__", None) is torch.Tensor.device:
            return torch.device("xpu")
        return super().__torch_function__(func, types, args, kwargs or {})
