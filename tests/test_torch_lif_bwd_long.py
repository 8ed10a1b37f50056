"""Row 3, the LIF surrogate backward, at long T on the CPU.

The port's plain version (`lif_scan.lif_bwd_plain`, which the card's
stream and slab ring equal bit for bit) and its wrappers on CPU tensors
against `repro`'s TPU kernel `_lif_bwd_pallas` in interpret mode, bit for
bit: T = 512 on an (8, 64) block and T = 257 on a ragged (7, 37), f32 and
bf16 cotangents, soft and hard reset, two surrogate alphas. The residual
comes from `repro`'s `_lif_fwd_pallas` on the same drive and equals the
port's `lif_fwd_plain`. The other CPU parity tests stop at T <= 5; the
slab ring walks chunks of 32 steps, so these lengths cross many chunks
and a ragged last one.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.lif_scan import _lif_bwd_pallas, _lif_fwd_pallas
from repro_torch.kernels import lif_scan


def _as_torch(a, dtype):
    """A jax array -> torch tensor of `dtype`, exactly (bf16 through f32)."""
    return torch.from_numpy(np.asarray(a.astype(jnp.float32))).to(dtype)


@pytest.mark.parametrize("shape", [(512, 8, 64), (257, 7, 37)],
                         ids=["t512", "t257_ragged"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("soft", [True, False], ids=["soft", "hard"])
@pytest.mark.parametrize("alpha", [2.0, 3.0])
def test_long_t_backward_equals_the_pallas_kernel(shape, dtype, soft, alpha):
    rng = np.random.default_rng([shape[0], int(soft), int(alpha),
                                 dtype.itemsize])
    x = rng.normal(0.2, 1.3, shape).astype(np.float32)
    g = rng.normal(0.0, 1.0, shape).astype(np.float32)
    jdtype = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jg = jnp.asarray(g).astype(jdtype)
    kw = dict(decay=0.5, v_th=1.0, soft_reset=soft)
    _, jvres = _lif_fwd_pallas(jnp.asarray(x), block_m=shape[1],
                               block_n=shape[2], **kw)
    jdx = _lif_bwd_pallas(jvres, jg, surrogate_alpha=alpha,
                          block_m=shape[1], block_n=shape[2], **kw)
    assert jdx.dtype == jdtype

    vres = torch.from_numpy(np.array(jvres))
    _, tvres = lif_scan.lif_fwd_plain(torch.from_numpy(x), **kw)
    assert torch.equal(tvres, vres)
    tg = _as_torch(jg, dtype)
    want = _as_torch(jdx, dtype)
    dx = lif_scan.lif_bwd_plain(vres, tg, surrogate_alpha=alpha, **kw)
    assert dx.dtype == dtype
    assert torch.equal(dx, want)
    # The wrappers take the plain version on CPU tensors, over (T, P).
    t, p = shape[0], shape[1] * shape[2]
    flat = (vres.reshape(t, p), tg.reshape(t, p))
    assert torch.equal(lif_scan.lif_bwd(*flat, surrogate_alpha=alpha, **kw),
                       want.reshape(t, p))
    for layout in lif_scan.BWD_LAYOUTS:
        assert torch.equal(lif_scan.lif_bwd_forced(
            *flat, layout, surrogate_alpha=alpha, **kw), want.reshape(t, p))


def test_forced_layouts_are_named():
    vres = torch.zeros(3, 5)
    with pytest.raises(ValueError):
        lif_scan.lif_bwd_forced(vres, vres, "ring")
    with pytest.raises(ValueError, match="differ"):
        lif_scan.lif_bwd_forced(vres, vres[:2], "stream")
