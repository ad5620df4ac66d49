"""K5r over the row-major copy of a CSC design, on the CPU: the copy
(``kernels/csc_score.py: row_major``) against ``row_order`` over the flat
arrays, K5r's plans (``matvec_plan``, ``UPDATE_PLAN``), and the plain
version over the copy
(``csc_row_sum_plain`` with `order` None) against the plain version
over an order and against the CPU route's ``index_add_`` (``csc_matvec``,
``csc_incremental_xb``), bit for bit: on the CPU they are the same adds
in the same order. The sort-free update (the slot map of the working set,
each row's kept entries ranked by slot) runs no sort."""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import repro_torch.core  # noqa: F401  (imports kernels.ops first)
from repro_torch.kernels import csc_score, ops
from repro_torch.kernels.csc_score import (K5R_LONG, UPDATE_PLAN,
                                           UpdatePlan, csc_row_sum_plain,
                                           matvec_plan, plan_ctas, row_order)
from repro_torch.kernels.fused_ws import slot_map
from repro_torch.sparse import CSCDesign
from repro_torch.sparse.ops import csc_incremental_xb, csc_matvec

N, P = 240, 700


def _matrix(seed=0, n=N, p=P, dense_row=5, empty_row=7):
    """A sparse n x p matrix with one row holding every column (present in
    every slot of any working set), one empty row and some explicit
    zeros."""
    rng = np.random.default_rng(seed)
    X = sp.random(n, p, density=0.02, random_state=seed, format="lil")
    X[dense_row, :] = rng.standard_normal(p)
    X[empty_row, :] = 0.0
    X = X.tocsc()
    X.data[::17] = 0.0                   # explicit zeros stay in the arrays
    return X


def _designs():
    X = _matrix()
    d = CSCDesign.from_scipy(X, device="cpu")
    sub = torch.as_tensor(np.random.default_rng(3).choice(P, 300,
                                                          replace=False))
    slot = d.take_columns(sub)
    return {"from_scipy": d, "subset": slot}


@pytest.fixture(scope="module")
def designs():
    return _designs()


def _forced(monkeypatch):
    monkeypatch.setattr(CSCDesign, "ordered_sums", property(lambda s: True))


@pytest.mark.parametrize("kind", ["from_scipy", "subset"])
def test_copy_is_the_flat_arrays_in_row_order(designs, kind):
    """vals, cols and ptr are data, col_ids and the bounds of
    ``row_order`` over the flat arrays (zeros and padding left out, past
    ptr[-1])."""
    d = designs[kind]
    rm = d.row_major()
    order, ptr = row_order(d.indices, d.n_rows, d.data)
    E = int(ptr[-1])
    assert torch.equal(rm.ptr, ptr)
    assert torch.equal(rm.vals[:E], d.data[order[:E].long()])
    assert torch.equal(rm.cols[:E], d.col_ids[order[:E].long()])
    assert rm.vals.dtype == d.dtype and rm.cols.dtype == torch.int32
    assert rm.ptr.dtype == torch.int64
    assert E == int(torch.count_nonzero(d.data)) and E < d.capacity
    assert torch.all(rm.vals[E:] == 0)
    assert d.row_major() is rm                       # made once
    # within a row, ascending column
    rid = torch.repeat_interleave(torch.arange(d.n_rows), ptr.diff())
    key = rid * d.width + rm.cols[:E].long()
    assert torch.all(key[1:] > key[:-1])


def test_copy_is_rebuilt_in_place_after_a_refill():
    """``take_columns(out=)`` rewrites the slot design's copy in its own
    tensors (a captured step reads them in place), equal to a fresh copy
    of the new columns."""
    d = _designs()["from_scipy"]
    rng = np.random.default_rng(4)
    a = torch.as_tensor(rng.choice(P, 200, replace=False))
    slot = d.take_columns(a)
    rm = slot.row_major()
    ptrs = (rm.vals.data_ptr(), rm.cols.data_ptr(), rm.ptr.data_ptr())
    b = torch.as_tensor(rng.choice(P, 200, replace=False))
    out = d.take_columns(b, out=slot)
    assert out is slot and out.row_major() is rm
    assert ptrs == (rm.vals.data_ptr(), rm.cols.data_ptr(), rm.ptr.data_ptr())
    fresh = d.take_columns(b).row_major()
    E = int(fresh.ptr[-1])
    assert torch.equal(rm.ptr, fresh.ptr)
    assert torch.equal(rm.vals[:E], fresh.vals[:E])
    assert torch.equal(rm.cols[:E], fresh.cols[:E])


@pytest.mark.parametrize("T", [None, 1, 4])
@pytest.mark.parametrize("kind", ["from_scipy", "subset"])
def test_plain_over_the_copy_equals_the_plain_over_the_order(designs, kind,
                                                             T):
    """``matvec``'s plain version over the copy equals the plain version
    over ``row_order`` and the CPU route's ``csc_matvec``, bit for bit."""
    d = designs[kind]
    rng = np.random.default_rng(11)
    shape = (d.width,) if T is None else (d.width, T)
    beta = torch.as_tensor(rng.standard_normal(shape))
    rm = d.row_major()
    got = csc_row_sum_plain(rm.vals, None, rm.cols, rm.ptr, beta)
    order, ptr = row_order(d.indices, d.n_rows, d.data)
    old = csc_row_sum_plain(d.data, order, d.col_ids, ptr, beta)
    assert torch.equal(got, old)
    assert torch.equal(got, csc_matvec(d.data, d.indices, d.col_ids, beta,
                                       d.n_rows))
    assert torch.equal(ops.csc_row_sum(rm.vals, None, rm.cols, rm.ptr, beta),
                       got)


@pytest.mark.parametrize("order", ["random", "ascending"])
@pytest.mark.parametrize("T", [None, 1, 4])
@pytest.mark.parametrize("K", [1, 64, 512])
def test_sort_free_update_equals_the_windows(designs, K, T, order):
    """Xb + X_ws delta over the copy, keeping the entries whose column has
    a slot and adding each row's by ascending slot, equals the CPU route
    over the windows (``csc_incremental_xb``) bit for bit; row 5 holds an
    entry in every slot, row 7 none."""
    d = designs["from_scipy"]
    rng = np.random.default_rng(K + (T or 0))
    ws = rng.choice(d.width, K, replace=False)
    if order == "ascending":
        ws = np.sort(ws)
    ws = torch.as_tensor(ws)
    _, (rows, vals) = d.gather_ws(ws)
    tail = () if T is None else (T,)
    delta = torch.as_tensor(rng.standard_normal((K,) + tail))
    Xb = torch.as_tensor(rng.standard_normal((d.n_rows,) + tail))
    want = csc_incremental_xb(Xb, rows, vals, delta)
    rm = d.row_major()
    slots, bits = ops.ws_slot_map(ws, d.width)
    got = csc_row_sum_plain(rm.vals, None, rm.cols, rm.ptr, delta, base=Xb,
                            slots=slots)
    assert torch.equal(got, want)
    assert torch.equal(ops.csc_row_sum(rm.vals, None, rm.cols, rm.ptr,
                                       delta, base=Xb, slots=slots, bits=bits),
                       want)
    dense = Xb.numpy() + d.todense()[:, ws.numpy()] @ delta.numpy()
    assert np.max(np.abs(got.numpy() - dense)) <= 1e-13 * np.max(
        np.abs(dense))


@pytest.mark.parametrize("p", [12, 64, 70])
def test_slot_map_is_k3gs_at_one_lane_with_its_bitmap(p):
    """``ws_slot_map`` is K3g's ``slot_map`` at S = 1 (slot_of[ws[k]] = k,
    else -1) with its bitmap (bit j % 32 of word j // 32: column j has a
    slot); the CPU route counts no launch."""
    ws = torch.tensor([5, 0, 9, 3, p - 1])
    ops.reset_launch_counts()
    got, bits = ops.ws_slot_map(ws, p)
    assert got.dtype == torch.int32 and bits.dtype == torch.int32
    want = [-1] * p
    for k, j in enumerate(ws.tolist()):
        want[j] = k
    assert got.tolist() == want
    assert torch.equal(got, slot_map(ws[None], p)[:, 0])
    assert bits.shape == (-(-p // 32),)
    words = [w & 0xFFFFFFFF for w in bits.tolist()]
    assert [bool(words[j // 32] >> (j % 32) & 1) for j in range(p)] == \
        [s >= 0 for s in want]
    assert ops.row_sum_counts() == {"matvec": 0, "update_xb": 0,
                                    "slot_map": 0}


def _long_row_design(L=2500, n=60):
    X = _matrix(seed=2, n=n, p=L + 40, dense_row=3, empty_row=4)
    return CSCDesign.from_scipy(X, device="cpu")


PLANS = {"matvec T=1": lambda: matvec_plan(1),
         "matvec T=3": lambda: matvec_plan(3),
         "matvec T=20": lambda: matvec_plan(20),
         "matvec T=300": lambda: matvec_plan(300),
         "update": lambda: UPDATE_PLAN,
         "update, 7 rows": lambda: UpdatePlan(7, 16, K5R_LONG, 64)}


@pytest.mark.parametrize("plan", list(PLANS))
@pytest.mark.parametrize("kind", ["from_scipy", "subset", "long"])
def test_plans_cover_every_row_once(designs, kind, plan):
    """A plan's CTAs take consecutive rows, each once; a row of more than
    ``longer`` entries goes to the long path, the rest to the main loop;
    a matvec CTA holds a thread a (row, task), an update CTA a warp a row
    at a time with its buffer."""
    d = _long_row_design() if kind == "long" else designs[kind]
    rm = d.row_major()
    pl = PLANS[plan]()
    assert pl.longer == K5R_LONG and pl.threads % 32 == 0
    assert pl.threads <= (512 if plan.startswith("matvec") else 256)
    if plan.startswith("matvec"):
        T = int(plan.split("T=")[1].split(",")[0])
        assert pl.rows * T <= pl.threads
        assert pl.slice == (0 if T == 1 else 64)
    ptr = rm.ptr.tolist()
    seen, longs = [], []
    for main, long_rows in plan_ctas(pl, rm.ptr):
        assert len(main) + len(long_rows) <= pl.rows
        assert all(ptr[r + 1] - ptr[r] <= pl.longer for r in main)
        assert all(ptr[r + 1] - ptr[r] > pl.longer for r in long_rows)
        seen += sorted(main + long_rows)
        longs += long_rows
    assert seen == list(range(d.n_rows))
    if kind == "long":
        assert longs == [3]                 # the 2540-entry row


@pytest.mark.parametrize("T", [0, 513, 600])
def test_plans_refuse_what_the_kernels_cannot_launch(T):
    """No tasks, or more tasks than a CTA's 512 threads: refused."""
    with pytest.raises(ValueError):
        matvec_plan(T)


@pytest.mark.parametrize("T", [None, 3])
def test_long_row_sums_equal_the_cpu_route(T):
    """A row of 2540 entries (long at the plan's W = 1024): ``matvec`` and
    the update over the copy equal the CPU route bit for bit."""
    d = _long_row_design()
    rng = np.random.default_rng(8)
    tail = () if T is None else (T,)
    beta = torch.as_tensor(rng.standard_normal((d.width,) + tail))
    rm = d.row_major()
    assert torch.equal(
        ops.csc_row_sum(rm.vals, None, rm.cols, rm.ptr, beta),
        csc_matvec(d.data, d.indices, d.col_ids, beta, d.n_rows))
    ws = torch.as_tensor(rng.choice(d.width, 1500, replace=False))
    _, (rows, vals) = d.gather_ws(ws)
    delta = torch.as_tensor(rng.standard_normal((1500,) + tail))
    Xb = torch.as_tensor(rng.standard_normal((d.n_rows,) + tail))
    slots, bits = ops.ws_slot_map(ws, d.width)
    got = ops.csc_row_sum(rm.vals, None, rm.cols, rm.ptr, delta, base=Xb,
                          slots=slots, bits=bits)
    assert torch.equal(got, csc_incremental_xb(Xb, rows, vals, delta))


def test_forced_update_runs_no_sort(monkeypatch, designs):
    """With the card's route forced, ``update_xb`` (after the copy exists)
    calls neither ``row_order`` nor ``torch.sort`` and equals the CPU
    route bit for bit; ``matvec`` sorts only the first time."""
    d = _designs()["from_scipy"]
    rng = np.random.default_rng(5)
    beta = torch.as_tensor(rng.standard_normal(d.width))
    want_mv = d.matvec(beta)
    ws = torch.as_tensor(rng.choice(d.width, 64, replace=False))
    _, aux = d.gather_ws(ws)
    delta = torch.as_tensor(rng.standard_normal(64))
    Xb = torch.as_tensor(rng.standard_normal(d.n_rows))
    want = d.update_xb(Xb, None, aux, delta)
    _forced(monkeypatch)
    assert torch.equal(d.matvec(beta), want_mv)      # makes the copy
    calls = []
    real_sort = torch.sort

    def spy_sort(*a, **k):
        calls.append("sort")
        return real_sort(*a, **k)

    def no_order(*a, **k):
        raise AssertionError("update_xb called row_order")
    monkeypatch.setattr(torch, "sort", spy_sort)
    monkeypatch.setattr(csc_score, "row_order", no_order)
    assert torch.equal(d.update_xb(Xb, None, aux, delta), want)
    assert torch.equal(d.matvec(beta), want_mv)
    assert calls == []
