"""The port's segment sum and single-region membership on the CPU (their
plain versions) against the JAX package's kernels run as its own tests run
them (Pallas in interpret mode) and against its jnp references.

Tolerances: segment sums at the JAX package's own (rtol 1e-5 / atol 1e-3
for f32, rtol 2e-2 for f16 inputs), since the one-hot matmul of the
Pallas kernel adds in another order than ``index_add_``; the backward
(a gather) and membership exactly."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import csr as jcsr
from repro.kernels.intersect.ops import member as j_member
from repro.kernels.intersect.ref import member_ref as j_member_ref
from repro.kernels.segment_ops.ops import segment_sum as j_segment_sum
from repro.kernels.segment_ops.ref import segment_sum_ref as j_segsum_ref
from repro_torch import kernels as tkernels
from repro_torch.kernels.intersect.ops import member
from repro_torch.kernels.intersect.ref import member_ref
from repro_torch.kernels.segment_ops import segment_sum
from repro_torch.kernels.segment_ops.ref import segment_sum_ref


@pytest.fixture(autouse=True)
def _no_launches():
    """On the CPU every wrapper takes its plain version: no launch."""
    tkernels.reset_launches()
    yield
    assert sum(tkernels.launches().values()) == 0


def _tol(dtype):
    return dict(rtol=2e-2 if dtype == np.float16 else 1e-5, atol=1e-3)


@pytest.mark.parametrize("E,D,NS", [(1000, 64, 50), (513, 16, 2000),
                                    (256, 256, 1), (7, 8, 4), (300, 70, 33)])
@pytest.mark.parametrize("dtype", [np.float32, np.float16])
def test_segment_sum_matches_jax_kernel(E, D, NS, dtype):
    rng = np.random.default_rng(E + D)
    data = rng.normal(size=(E, D)).astype(dtype)
    seg = rng.integers(0, NS, E).astype(np.int32)
    got = segment_sum(torch.from_numpy(data), torch.from_numpy(seg), NS)
    assert got.dtype == torch.float32 and tuple(got.shape) == (NS, D)
    kern = np.asarray(j_segment_sum(jnp.asarray(data), jnp.asarray(seg),
                                    NS))
    ref = np.asarray(j_segsum_ref(jnp.asarray(data), jnp.asarray(seg), NS))
    np.testing.assert_allclose(got.numpy(), kern, **_tol(dtype))
    np.testing.assert_allclose(got.numpy(), ref, **_tol(dtype))


def test_segment_sum_sorted_promise_and_dropped_ids():
    """Sorted ids with the promise, ids equal to NS (the padding sentinel)
    and beyond dropped, empty segments zero, NS > E."""
    rng = np.random.default_rng(3)
    E, D, NS = 500, 32, 600
    data = rng.normal(size=(E, D)).astype(np.float32)
    seg = np.sort(rng.integers(0, 60, E)).astype(np.int32)
    seg[-40:] = NS
    seg[-5:] = NS + 7
    td, ts = torch.from_numpy(data), torch.from_numpy(seg)
    a = segment_sum(td, ts, NS, is_sorted=True)
    b = segment_sum(td, ts, NS)
    kern = np.asarray(j_segment_sum(jnp.asarray(data), jnp.asarray(seg), NS,
                                    is_sorted=True))
    ref = np.asarray(j_segsum_ref(jnp.asarray(data), jnp.asarray(seg), NS))
    for got in (a, b):
        np.testing.assert_allclose(got.numpy(), kern, rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-4)
    assert not a[60:].any()
    torch.testing.assert_close(segment_sum_ref(td, ts, NS), a, rtol=0,
                               atol=0)


@pytest.mark.parametrize("dtype", [np.float32, np.float16])
def test_segment_sum_backward_is_jax_gather(dtype):
    """The autograd backward equals ``jax.grad`` through
    ``jax.ops.segment_sum`` (what it transposes to) exactly: grad_out[seg],
    0 for ids >= NS."""
    rng = np.random.default_rng(11)
    E, D, NS = 300, 7, 40
    data = rng.normal(size=(E, D)).astype(dtype)
    seg = rng.integers(0, NS + 5, E).astype(np.int32)
    cot = rng.normal(size=(NS, D)).astype(np.float32)

    def jloss(x):
        out = jax.ops.segment_sum(x.astype(jnp.float32), jnp.asarray(seg),
                                  num_segments=NS)
        return jnp.sum(out * jnp.asarray(cot))

    want = np.asarray(jax.grad(jloss)(jnp.asarray(data)))
    x = torch.from_numpy(data).requires_grad_(True)
    out = segment_sum(x, torch.from_numpy(seg), NS)
    (out * torch.from_numpy(cot)).sum().backward()
    assert x.grad.dtype == x.dtype
    np.testing.assert_array_equal(x.grad.numpy(), want)


def _member_case(rng, composite, narrow):
    if composite:
        rows = rng.integers(0, 9, (260, 4)).astype(np.int32)
        idx = jcsr.build_index(rows, (0, 1, 2), 3, 384, narrow=narrow)
        q = np.concatenate([rows[rng.integers(0, 260, 150)],
                            rng.integers(0, 10, (150, 4)).astype(np.int32)])
        qk, ql = jcsr.pack_key(tuple(q[:, c] for c in range(3)))
        qv = q[:, 3]
    else:
        rows = rng.integers(0, 40, (300, 2)).astype(np.int32)
        idx = jcsr.build_index(rows, (0,), 1, 384, narrow=narrow)
        q = np.concatenate([rows[rng.integers(0, 300, 150)],
                            rng.integers(0, 45, (150, 2)).astype(np.int32)])
        qk, ql, qv = q[:, 0], None, q[:, 1]
    qk = np.asarray(qk).astype(np.asarray(idx.key).dtype)
    return idx, qk, ql, qv


@pytest.mark.parametrize("narrow", [True, False], ids=["i32", "i64"])
@pytest.mark.parametrize("composite", [False, True], ids=["1word", "lex"])
def test_member_matches_jax_kernel(composite, narrow):
    rng = np.random.default_rng(5 + composite)
    idx, qk, ql, qv = _member_case(rng, composite, narrow)
    j_args = (idx.key, idx.val, idx.n, jnp.asarray(qk), jnp.asarray(qv))
    j_lo = {} if ql is None else dict(los=idx.lo, ql=jnp.asarray(ql))
    kern = np.asarray(j_member(*j_args, **j_lo))
    if ql is None:
        ref = np.asarray(j_member_ref(*j_args))
    else:  # the jnp oracle of the composite kernel: the 3-word search
        ref = np.asarray(jcsr.index_member(idx, (jnp.asarray(qk),
                                                 jnp.asarray(ql)),
                                           jnp.asarray(qv)))
    t = dict(keys=torch.from_numpy(np.array(idx.key)),
             vals=torch.from_numpy(np.array(idx.val)),
             n=torch.tensor(int(idx.n), dtype=torch.int32),
             qk=torch.from_numpy(qk), qv=torch.from_numpy(qv))
    t_lo = {} if ql is None else dict(
        los=torch.from_numpy(np.array(idx.lo)),
        ql=torch.from_numpy(np.asarray(ql)))
    got = member(**t, **t_lo)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), kern)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(member_ref(**t, **t_lo).numpy(), kern)
    assert kern.any() and not kern.all()
