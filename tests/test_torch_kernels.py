"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU every port wrapper takes its plain PyTorch version (the CUDA
kernels build and run only on the card, where ``chip_smoke.py`` holds each
one against that plain version). Here the plain versions are held against
the Pallas kernels run in interpret mode, at the shapes of
``tests/test_kernels.py``, in f32 and bf16. Both packages upcast bf16
inputs to f32 before any arithmetic, so one f32 tolerance covers both
dtypes: |got − want| ≤ 1e-5·|want| + 1e-6·max|want| elementwise. The sums
(up to 4096 f32 terms) are taken in another order by XLA and by PyTorch, and
an output that cancels to near zero keeps the rounding of its largest
terms, hence the part scaled by the largest output."""
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.kernels.dp_clip import kernel as jdp_kernel, ops as jdp_ops
from repro.kernels.l1_distance import ops as jl1_ops
from repro_torch.config import KernelConfig
from repro_torch.kernels import dispatch
from repro_torch.kernels.dp_clip import kernel as dp_kernel, ops as dp_ops, ref as dp_ref
from repro_torch.kernels.l1_distance import kernel as l1_kernel, ops as l1_ops, ref as l1_ref

DTYPES = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)]


def assert_close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    bound = 1e-5 * np.abs(want) + 1e-6 * np.abs(want).max()
    bad = np.abs(got - want) > bound
    assert not bad.any(), (np.abs(got - want)[bad].max(), bad.sum())


def _inputs(shape, jdtype, tdtype, seed=0, scale=3.0, norms=None):
    """The same values for both packages: numpy normal draws rounded to the
    working dtype once, in JAX, and carried across bit for bit. ``norms``
    spreads the rows' l2 norms over [lo, hi] so that the clip scale is 1 for
    some rows and < 1 for others."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape) * scale
    if norms is not None:
        target = np.exp(rng.uniform(np.log(norms[0]), np.log(norms[1]), shape[:-1] + (1,)))
        x = x / np.linalg.norm(x, axis=-1, keepdims=True) * target
    x = x.astype(np.float32)
    xj = jnp.asarray(x).astype(jdtype)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(tdtype)
    return xj, xt


def _pad(x, mb, md):
    B, D = x.shape
    return jnp.pad(x, ((0, (-B) % mb), (0, (-D) % md)))


@pytest.mark.parametrize("B,D", [(4, 64), (8, 1000), (16, 4096), (5, 333)])
@pytest.mark.parametrize("jdtype,tdtype", DTYPES)
def test_sq_norms_matches_pallas(B, D, jdtype, tdtype):
    xj, xt = _inputs((B, D), jdtype, tdtype)
    want = jdp_kernel.sq_norms(_pad(xj, 4, 256), tb=4, td=256, interpret=True)[:B]
    got = dp_ops.sq_norms(xt)
    assert got.dtype == torch.float32 and got.shape == (B,)
    assert_close(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("B,D", [(4, 64), (8, 1000), (16, 4096), (5, 333)])
@pytest.mark.parametrize("jdtype,tdtype", DTYPES)
def test_scale_accumulate_matches_pallas(B, D, jdtype, tdtype):
    xj, xt = _inputs((B, D), jdtype, tdtype, seed=1)
    scales = np.random.default_rng(2).uniform(0.1, 2.0, B).astype(np.float32)
    sp = jnp.pad(jnp.asarray(scales), (0, (-B) % 4))
    want = jdp_kernel.scale_accumulate(_pad(xj, 4, 256), sp, tb=4, td=256,
                                       interpret=True)[:D]
    got = dp_ref.scale_accumulate(xt, torch.from_numpy(scales))
    assert_close(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("B,D", [(4, 64), (8, 1000), (16, 4096), (5, 333)])
@pytest.mark.parametrize("jdtype,tdtype", DTYPES)
def test_clip_accumulate_matches_pallas(B, D, jdtype, tdtype):
    """Both passes with the clip scales (some rows clipped, some not) and the
    1/denom mean folded in, through the port's device-routed pipeline."""
    xj, xt = _inputs((B, D), jdtype, tdtype, seed=3, norms=(0.2, 4.0))
    want = jdp_ops.clip_accumulate_flat(xj, 0.9, denom=float(B), tb=4, td=256)
    got = dp_ops.clip_accumulate(xt.unsqueeze(0), 0.9, float(B))[0]
    norms = np.sqrt(dp_ref.sq_norms(xt).numpy())
    assert (norms > 0.9).any() and (norms < 0.9).any()
    assert_close(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("jdtype,tdtype", DTYPES)
def test_batched_clip_accumulate_matches_pallas(jdtype, tdtype):
    """The client axis written out: (M, B, D) -> (M, D) against the Pallas
    pipeline vmapped over M (pallas_call's batching rule adds M to the grid)."""
    M, B, D = 3, 5, 333
    xj, xt = _inputs((M, B, D), jdtype, tdtype, seed=4, norms=(0.2, 4.0))
    want = jax.vmap(lambda a: jdp_ops.clip_accumulate_flat(a, 1.0, denom=float(B),
                                                           tb=4, td=256))(xj)
    got = dispatch.clip_accumulate(xt, 1.0, denom=float(B))
    assert got.shape == (M, D)
    assert_close(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("M,D", [(4, 128), (10, 500), (16, 2048), (7, 129)])
@pytest.mark.parametrize("jdtype,tdtype", DTYPES)
def test_pairwise_l1_matches_pallas(M, D, jdtype, tdtype):
    xj, xt = _inputs((M, D), jdtype, tdtype, seed=5, scale=2.0)
    want = jl1_ops.pairwise_l1(xj, tm=4, td=128)
    got = l1_ops.pairwise_l1(xt)
    assert got.dtype == torch.float32
    assert_close(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), got.numpy().T)
    assert not np.diag(got.numpy()).any()


# ---------------------------------------------------------------------------
# Routing: plain version only for a CPU tensor, never a silent fallback
# ---------------------------------------------------------------------------

def _forbid_plain(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("plain version ran for a CUDA request")
    for mod, names in ((dp_ref, ("sq_norms", "scale_accumulate", "clip_scale_accumulate",
                                 "clip_accumulate")), (l1_ref, ("pairwise_l1",))):
        for n in names:
            monkeypatch.setattr(mod, n, boom)


def test_cuda_backend_on_cpu_tensor_raises(monkeypatch):
    _forbid_plain(monkeypatch)
    cuda = KernelConfig(backend="cuda")
    with pytest.raises(ValueError, match="backend='cuda'"):
        dispatch.clip_accumulate(torch.ones(2, 3, 4), 1.0, kernels=cuda)
    with pytest.raises(ValueError, match="backend='cuda'"):
        dispatch.dp_clip_flat(torch.ones(2, 3, 4), 1.0, torch.zeros(2, 4), sigma=1.0,
                              kernels=cuda)
    with pytest.raises(ValueError, match="backend='cuda'"):
        dispatch.pairwise_l1(torch.ones(3, 4), kernels=cuda)
    with pytest.raises(ValueError, match="unknown kernel backend"):
        dispatch.pairwise_l1(torch.ones(3, 4), kernels=KernelConfig(backend="triton"))


def test_kernel_wrappers_refuse_cpu_tensors(monkeypatch):
    _forbid_plain(monkeypatch)
    dispatch.reset_launches()
    with pytest.raises(ValueError, match="CUDA tensor"):
        dp_kernel.sq_norms(torch.ones(2, 3))
    with pytest.raises(ValueError, match="CUDA tensor"):
        dp_kernel.scale_accumulate(torch.ones(1, 2, 3), torch.ones(1, 2), 1.0)
    with pytest.raises(ValueError, match="CUDA tensor"):
        l1_kernel.pairwise_l1(torch.ones(2, 3))
    assert dispatch.launch_counts() == {"sq_norms": 0, "scale_accumulate": 0,
                                        "pairwise_l1": 0}


def test_cpu_path_counts_no_launches():
    dispatch.reset_launches()
    dispatch.clip_accumulate(torch.ones(2, 3, 4), 1.0)
    dispatch.pairwise_l1(torch.ones(3, 4))
    assert dispatch.launch_counts() == {"sq_norms": 0, "scale_accumulate": 0,
                                        "pairwise_l1": 0}


def test_l1_split_covers_d():
    """The wrapper's D split: chunks are whole shared-memory steps and cover
    D; enough chunks to fill the card unless a chunk is one step."""
    for M, D in [(260, 155530), (7, 129), (16, 2048), (1000, 64)]:
        S, chunk = l1_kernel.split_d(M, D, tm=64, kd=32, sms=132)
        assert chunk % 32 == 0 and S * chunk >= D and (S - 1) * chunk < D
        T = -(-M // 64)
        assert chunk == 32 or T * (T + 1) // 2 * S >= 132
