"""One host read per outer step: the port's ``SolveResult.n_host_syncs``
against the reference's contract and counts, on the CPU.

The reference reads back once per outer iteration (DESIGN.md §3.1), so a
cold solve makes ``len(kkt_history)`` reads and a warm start that probes
its support one more (``tests/test_engine.py``,
``test_single_host_sync_per_outer_iteration``). The port runs the same
step under a host flow on the CPU (``core/flow.py``): its conditions are
tested in host memory and its one read at the end of the step is counted.
Each case solves the same seeded problem through the reference's jax
backend and through ``repro_torch`` on both routes, and holds the port to
the contract and to the reference's ``n_host_syncs``, ``n_outer`` and
``n_epochs``. The cases cover the Gram inner solve (dense and CSC Lasso),
the Xb inner solve (dense logistic), the SVC dual and a multitask Lasso,
at the sizes of ``tests/test_engine.py``, at tol 1e-6. (At 1e-9 the last
outer steps turn on rounding: an Anderson acceptance test between two
objective values equal to their last bits, which the two packages round
differently, can take one outer step more or fewer on either side, with
the coefficients equal to 1e-6 all the same.)
"""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp

import repro.core as jc
import repro_torch.core as tc
from repro.sparse import CSCDesign as JCSCDesign
from repro_torch.sparse import CSCDesign

CPU = "cpu"
TOL = 1e-6


def _lasso(lasso_data):
    X, y, _ = lasso_data
    X, y = np.asarray(X), np.asarray(y)
    return X, y, jc.lambda_max(jnp.asarray(X), jnp.asarray(y)) / 30


def _csc(lasso_data):
    X, y, lam = _lasso(lasso_data)
    Xs = sp.csc_matrix(X * (np.random.default_rng(3).random(X.shape) < 0.3))
    return Xs, y, jc.lambda_max(JCSCDesign.from_scipy(Xs), jnp.asarray(y)) \
        / 30


def _case(name, data):
    """(reference solve kwargs, port solve kwargs) of one case: the
    arrays, datafit and penalty on each side."""
    lasso_data, logreg_data, multitask_data = data
    if name == "dense-lasso":
        X, y, lam = _lasso(lasso_data)
        return (dict(X=jnp.asarray(X), y=jnp.asarray(y),
                     datafit=jc.Quadratic(), penalty=jc.L1(lam)),
                dict(X=X, y=y, datafit=tc.Quadratic(), penalty=tc.L1(lam)))
    if name == "csc-lasso":
        Xs, y, lam = _csc(lasso_data)
        return (dict(X=JCSCDesign.from_scipy(Xs), y=jnp.asarray(y),
                     datafit=jc.Quadratic(), penalty=jc.L1(lam)),
                dict(X=CSCDesign.from_scipy(Xs, ell=True, device=CPU), y=y,
                     datafit=tc.Quadratic(), penalty=tc.L1(lam)))
    if name == "dense-logistic":
        X, y, _ = logreg_data
        X, y = np.asarray(X), np.asarray(y)
        lam = jc.lambda_max(jnp.asarray(X), jnp.asarray(y),
                            jc.Logistic()) / 10
        return (dict(X=jnp.asarray(X), y=jnp.asarray(y),
                     datafit=jc.Logistic(), penalty=jc.L1(lam)),
                dict(X=X, y=y, datafit=tc.Logistic(), penalty=tc.L1(lam)))
    if name == "svc-dual":
        X, y, _ = logreg_data
        X, y = np.asarray(X), np.asarray(y)
        Zt = (y[:, None] * X).T
        return (dict(X=jnp.asarray(Zt), y=jnp.asarray(y),
                     datafit=jc.QuadraticSVC(), penalty=jc.Box(1.0)),
                dict(X=Zt, y=y, datafit=tc.QuadraticSVC(),
                     penalty=tc.Box(1.0)))
    X, Y, _ = multitask_data
    X, Y = np.asarray(X), np.asarray(Y)
    lam = jc.lambda_max(jnp.asarray(X), jnp.asarray(Y),
                        jc.MultitaskQuadratic()) / 10
    return (dict(X=jnp.asarray(X), y=jnp.asarray(Y),
                 datafit=jc.MultitaskQuadratic(), penalty=jc.BlockL1(lam)),
            dict(X=X, y=Y, datafit=tc.MultitaskQuadratic(),
                 penalty=tc.BlockL1(lam)))


CASES = ["dense-lasso", "csc-lasso", "dense-logistic", "svc-dual",
         "multitask-lasso"]


@pytest.mark.parametrize("use_kernels", [False, True], ids=["plain",
                                                            "kernels"])
@pytest.mark.parametrize("name", CASES)
def test_one_read_per_outer_step(name, use_kernels, lasso_data, logreg_data,
                                 multitask_data):
    ref, port = _case(name, (lasso_data, logreg_data, multitask_data))
    rj = jc.solve(ref.pop("X"), ref.pop("y"), ref.pop("datafit"),
                  ref.pop("penalty"), tol=TOL)
    args = (port.pop("X"), port.pop("y"), port.pop("datafit"),
            port.pop("penalty"))
    rt = tc.solve(*args, tol=TOL, device=CPU, use_kernels=use_kernels)
    assert rj.converged and rt.converged
    assert rt.n_host_syncs == len(rt.kkt_history)
    assert (rt.n_host_syncs, rt.n_outer, rt.n_epochs) == \
        (rj.n_host_syncs, rj.n_outer, rj.n_epochs)
    # a warm start probes its support once, then reads once a step
    warm = tc.solve(*args, tol=TOL, device=CPU, use_kernels=use_kernels,
                    beta0=rt.beta)
    assert warm.n_host_syncs == len(warm.kkt_history) + 1
