"""The schedule of the sparse score pass K5/K5s/K5b (``lane_plan`` and
``emulate`` in ``repro_torch/kernels/csc_score.py``).

The plan is plain Python; the emulation computes the kernel's result in
torch in the kernel's own summation order. These tests hold the plan to
what ``csrc/csc_score.cu`` needs (V values a lane that divide T, at most 32
lanes an entry, 32 // G entries an iteration), and the emulation to the
plain segment sum (``csc_score_plain``) and to the reference's
``repro.sparse.ops`` on the same numpy inputs within 1e-12, and bit for
bit to the order it promises: at T = 1 K5's lane-strided sums and shuffle
tree, above it E slot sums added in slot order, entry order where E = 1.
The designs: empty columns, a dense column, a column of 40 entries in the
first rows, a 1000-entry head column, a last row, fewer columns than SMs;
float64 and float32; square mode (K5s). The gpu tests
(``tests/test_torch_gpu.py``) hold the kernel to this emulation bit for
bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from repro.sparse import ops as jops
from repro_torch.kernels import ops  # noqa: F401  (before the submodule)
from repro_torch.kernels import csc_score as cs
from repro_torch.sparse import CSCDesign

F64, F32 = torch.float64, torch.float32


def _design(kind, seed=0):
    """scipy CSC fixtures: 'random' (uniform), 'edges' (n = 20,011: empty
    columns, one dense column, a column of the first 40 rows, a 1000-entry
    head column, the last row) and 'narrow' (p = 50, fewer columns than
    the card's SMs)."""
    rng = np.random.default_rng(seed)
    if kind == "narrow":
        return sp.random(700, 50, density=0.05, random_state=seed,
                         format="csc", data_rvs=rng.standard_normal)
    n, p = (20_011, 300) if kind == "edges" else (900, 1200)
    X = sp.random(n, p, density=0.004 if kind == "edges" else 0.01,
                  random_state=seed, format="csc",
                  data_rvs=rng.standard_normal).tolil()
    if kind == "edges":
        X[:, 3:9] = 0.0                              # empty columns
        X[:, 12] = rng.standard_normal((n, 1))       # every row
        X[:, 20] = 0.0
        X[:40, 20] = rng.standard_normal((40, 1))    # the first 40 rows
        X[:, 0] = 0.0
        X[rng.choice(n, 1000, replace=False), 0] = 1.0   # a head column
        X[-1, p - 1] = 2.0                           # the last row
    X = X.tocsc()
    X.eliminate_zeros()
    X.sort_indices()
    return X


def _arrays(X, dtype=F64):
    d = CSCDesign.from_scipy(X, dtype=np.float64 if dtype == F64
                             else np.float32, device="cpu")
    return d, (d.data, d.indices, d.col_ids, d.indptr)


def _lane_tree(X, v, dtype, square=False, L=32):
    """out_j = the shuffle-down tree (L / 2, ..., 2, 1) over L lane sums,
    lane l summing the products of entries indptr[j] + l (mod L) in entry
    order from 0.0 (L = 32: the order of the walk K5 ran before its
    16-lane one), column by column."""
    v = np.asarray(v)
    out = np.zeros(X.shape[1], np.float64)
    npd = np.float64 if dtype == F64 else np.float32
    for j in range(X.shape[1]):
        s, e = X.indptr[j], X.indptr[j + 1]
        x = X.data[s:e].astype(npd)
        g = v[X.indices[s:e]].astype(npd)
        prod = ((x * x) * g if square else x * g).astype(np.float64)
        lanes = np.zeros(L)
        for k in range(e - s):
            lanes[k % L] = lanes[k % L] + prod[k]
        o = L // 2
        while o:
            lanes[:o] = lanes[:o] + lanes[o:2 * o]
            o //= 2
        out[j] = lanes[0]
    return out.astype(npd)


# --------------------------------------------------------------- the plan
def test_lane_plan():
    assert cs.lane_plan(1) == (1, cs.K5_LANES, cs.K5_LANES)
    assert cs.lane_plan(2) == (2, 1, 32)
    assert cs.lane_plan(3) == (1, 3, 10)
    assert cs.lane_plan(20) == (2, 10, 3)
    assert cs.lane_plan(50) == (2, 25, 1)
    assert cs.lane_plan(200) == (2, 32, 1)
    assert cs.lane_plan(257) == (1, 32, 1)
    for T in range(2, 300):
        V, G, E = cs.lane_plan(T)
        assert V in (1, 2) and T % V == 0
        assert 1 <= G <= 32 and E * G <= 32 and E >= 1
        # a task block of G V tasks covers T, or 32 V of it
        assert G * V >= min(T, 32 * V)


# ------------------------------------------------------------ emulation
@pytest.mark.parametrize("dtype", [F64, F32], ids=["f64", "f32"])
@pytest.mark.parametrize("T", [1, 3, 20, 50])
@pytest.mark.parametrize("kind", ["random", "edges", "narrow"])
def test_emulation_matches_plain_and_reference(kind, T, dtype):
    X = _design(kind)
    d, args = _arrays(X, dtype)
    rng = np.random.default_rng(4)
    raw = rng.standard_normal((X.shape[0], T)) if T > 1 \
        else rng.standard_normal(X.shape[0])
    rt = torch.as_tensor(raw, dtype=dtype)
    # float32: the kernel rounds each product to float32 and sums in
    # float64; the plain version and the reference are run in float64 on
    # the same float32 values (summed in float32 they drift by ~5e-4 on
    # the 20,011-entry column), within 1e-4 (the products' rounding)
    tol = 1e-12 if dtype == F64 else 1e-4
    args = tuple(a.double() if a.dtype == F32 else a for a in args)
    J = dict(data=jnp.asarray(args[0].numpy()),
             indices=jnp.asarray(d.indices.numpy()),
             col_ids=jnp.asarray(d.col_ids.numpy()))
    for square in ((False, True) if T == 1 else (False,)):
        v = rt.abs() + 0.5 if square else rt
        got = cs.emulate(d.data, d.indices, d.indptr, v, square=square)
        assert got.dtype == dtype and got.shape == (X.shape[1],) + v.shape[1:]
        torch.testing.assert_close(
            got.double(), cs.csc_score_plain(*args, v.double(), square=square),
            atol=tol, rtol=tol)
        if square:
            want = jops.csc_weighted_col_sq(**J, w=jnp.asarray(
                v.double().numpy()), p=X.shape[1])
        else:
            want = jops.csc_score(**J, raw=jnp.asarray(v.double().numpy()),
                                  p=X.shape[1])
        np.testing.assert_allclose(got.double().numpy(), np.asarray(want),
                                   atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [F64, F32], ids=["f64", "f32"])
@pytest.mark.parametrize("square", [False, True], ids=["score", "square"])
@pytest.mark.parametrize("kind", ["random", "edges", "narrow"])
def test_emulation_at_t1_is_lane_order(kind, square, dtype):
    """At T = 1 (L = K5_LANES lanes a column) the result is bit for bit:
    lane l sums entries l, l + L, ... of a column, the L lane sums add by
    the shuffle-down tree."""
    L = cs.K5_LANES
    X = _design(kind)
    d, _ = _arrays(X, dtype)
    v = torch.as_tensor(np.random.default_rng(2).standard_normal(X.shape[0]),
                        dtype=dtype)
    if square:
        v = v.abs() + 0.5
    got = cs.emulate(d.data, d.indices, d.indptr, v, square=square)
    assert got.dtype == dtype
    assert torch.equal(got, torch.as_tensor(
        _lane_tree(X, v.numpy(), dtype, square=square, L=L)))


@pytest.mark.parametrize("T", [50, 200, 257])
def test_emulation_entry_order(T):
    """At one entry an iteration (E = 1: T = 50, 200, and 257 in task
    blocks) each column sums in entry order: bit for bit a sequential
    sum."""
    X = _design("edges")
    d, _ = _arrays(X)
    raw = np.random.default_rng(5).standard_normal((X.shape[0], T))
    assert cs.lane_plan(T)[2] == 1
    want = np.zeros((X.shape[1], T))
    for j in range(X.shape[1]):
        acc = np.zeros(T)
        for k in range(X.indptr[j], X.indptr[j + 1]):
            acc = acc + X.data[k] * raw[X.indices[k]]
        want[j] = acc
    got = cs.emulate(d.data, d.indices, d.indptr, torch.as_tensor(raw))
    assert torch.equal(got, torch.as_tensor(want))


@pytest.mark.parametrize("T,V,E", [(20, 2, 3), (3, 1, 10), (2, 2, 32)])
def test_emulation_slot_order(T, V, E):
    """At E entries an iteration (T = 20: 3; T = 3: 10; T = 2: 32) slot e
    sums entries e, e + E, ... of a column in order and the slots add in
    order 0 .. E-1: bit for bit."""
    X = _design("edges")
    d, _ = _arrays(X)
    raw = np.random.default_rng(6).standard_normal((X.shape[0], T))
    assert cs.lane_plan(T)[::2] == (V, E)
    got = cs.emulate(d.data, d.indices, d.indptr, torch.as_tensor(raw))
    for j in (0, 12, 20, X.shape[1] - 1):
        s, e = X.indptr[j], X.indptr[j + 1]
        slots = np.zeros((E, T))
        for k in range(s, e):
            slots[(k - s) % E] = slots[(k - s) % E] \
                + X.data[k] * raw[X.indices[k]]
        tot = slots[0]
        for q in range(1, E):
            tot = tot + slots[q]
        assert np.array_equal(got[j].numpy(), tot)
