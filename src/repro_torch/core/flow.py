"""Control flow of the outer step: on the host, or captured into a CUDA
graph with the decisions on the card.

The reference runs one outer iteration as one XLA program: the inner solve
sits under a ``lax.cond`` on "the incoming iterate does not yet pass tol"
and its Anderson blocks in a ``lax.while_loop`` on "blocks left and the
restricted kkt above eps", so the host reads back once an iteration.
``SolveEngine`` writes the step once against the two operations of a flow
and runs it under one of two:

  HostFlow      tests each condition on the host. On the CPU that reads
                host memory (no device transfer, not counted); on the card
                every test is a blocking read, counted in ``reads``. The
                CPU route runs on it, and so does the card's eager oracle
                (``EngineConfig(capture=False)``), which tests use to hold
                the captured step to the per-block loop bit for bit.
  CapturedFlow  inside a CUDA graph capture: ``branch`` becomes
                a conditional IF node and ``loop`` a conditional WHILE
                node (``csrc/graph_ctl.cu``) whose condition the body's
                last node sets from a device flag. Each body is captured on
                a stream of its own, with its allocations routed to a
                private memory pool of the engine.

A flow's ``branch(flag, body)`` runs ``body()`` when the 0-d bool tensor
``flag`` holds; ``loop(flag, body)`` runs ``body()`` while it holds, and
the body updates ``flag`` in place. Bodies communicate through tensors
allocated outside them and written in place.

Bodies nest to ``MAX_DEPTH`` levels: the outer step has two (the skip
branch and the Anderson loop inside it); the chunked lane step has three
(the device-side outer loop, the branch on "some lane runs" and the lanes'
inner loop).

Kernel launches inside a capture happen at each replay, not at the
wrapper's call: ``CapturedFlow`` collects them per body
(``kernels.ops.deferred_launches``) and the engine adds them to the launch
counts after each replay, as many times as each body ran, from the counts
the step reads back.
"""
from __future__ import annotations

import ctypes

import torch

from ..kernels import ops as kops
from ..kernels._build import BUILD

__all__ = ["HostFlow", "CapturedFlow", "GraphPools", "graph_streams",
           "MAX_DEPTH"]

_IF, _WHILE = 0, 1
# the deepest nesting of conditional bodies a captured step uses
MAX_DEPTH = 3


class HostFlow:
    """Conditions tested on the host; ``reads`` counts the tests that were
    blocking device-to-host transfers."""

    def __init__(self):
        self.reads = 0

    def _test(self, flag) -> bool:
        if flag.device.type != "cpu":
            self.reads += 1
        return bool(flag)

    def branch(self, flag, body):
        if self._test(flag):
            body()

    def loop(self, flag, body):
        while self._test(flag):
            body()


class GraphPools:
    """The private memory pools of one engine's captured steps: one for the
    step graphs, and one for each depth of conditional body (a pool takes
    its allocations through one filter at a time, so nested bodies keep
    pools apart). ``release`` hands them back to the caching allocator once
    the graphs that use them are gone."""

    def __init__(self, device):
        self.device = _indexed(device)
        self.ids = [torch.cuda.graph_pool_handle()
                    for _ in range(MAX_DEPTH + 1)]
        self._uses = [0] * (MAX_DEPTH + 1)

    def begin(self, depth):
        """Route the current stream's allocations to the pool of `depth`."""
        torch._C._cuda_beginAllocateCurrentStreamToPool(self.device.index,
                                                        self.ids[depth])
        self._uses[depth] += 1

    def end(self, depth):
        torch._C._cuda_endAllocateToPool(self.device.index, self.ids[depth])

    def release(self):
        for depth, uses in enumerate(self._uses):
            for _ in range(uses):
                torch._C._cuda_releasePool(self.device.index, self.ids[depth])
        self._uses = [0] * (MAX_DEPTH + 1)


# the capture stream and one side stream per body depth, per device, for
# the process: each holds its own library workspaces, made once outside
# any capture
_STREAMS: dict = {}


def _indexed(device):
    """`device` with its index ("cuda" -> "cuda:<current>")."""
    device = torch.device(device)
    if device.index is None:
        device = torch.device(device.type, torch.cuda.current_device())
    return device


def graph_streams(device):
    """[capture stream, one body stream for each depth 1..MAX_DEPTH] of
    `device`, with the cuBLAS and cuSOLVER handles and workspaces that the
    step uses made on each, outside any capture (a handle cannot be made
    while a stream captures)."""
    device = _indexed(device)
    if device not in _STREAMS:
        streams = [torch.cuda.Stream(device) for _ in range(MAX_DEPTH + 1)]
        a = torch.eye(8, dtype=torch.float64, device=device)
        for s in streams:
            s.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(s):
                torch.mm(a, a)
                torch.linalg.solve_ex(a, a[:, :1])
                # the lane step's batched products and solves
                torch.bmm(a[None], a[None])
                torch.linalg.solve_ex(a.expand(2, 8, 8), a[None, :, :1]
                                      .expand(2, 8, 1))
            torch.cuda.current_stream(device).wait_stream(s)
        _STREAMS[device] = streams
    return _STREAMS[device]


def _check(rc, what):
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA graph conditional node failed "
                           f"with code {rc}")


class CapturedFlow:
    """``branch`` and ``loop`` as conditional IF and WHILE nodes of the
    graph being captured on the current stream. ``scopes`` collects the
    kernel launches of each body with its kind and depth: ``("branch",
    depth, launches)`` and ``("loop", depth, launches)``, innermost body
    first."""

    def __init__(self, device, pools: GraphPools):
        self.device = _indexed(device)
        self.pools = pools
        self.capture_stream, *self.streams = graph_streams(self.device)
        # device-side launch statistics must exist before the capture
        kops.rows_read_counter(self.device)
        self.lib = BUILD.lib("graph_ctl")
        self.depth = 0
        self.scopes = []

    def _node(self, kind, flag, body):
        if flag.dtype != torch.bool or flag.numel() != 1:
            raise TypeError("a flow condition must be a 0-d bool tensor")
        if self.depth >= MAX_DEPTH:
            raise RuntimeError(f"conditional bodies nest at most {MAX_DEPTH} "
                               f"deep")
        parent = torch.cuda.current_stream(self.device)
        child = self.streams[self.depth]
        handle = ctypes.c_ulonglong()
        _check(self.lib.cond_begin(parent.cuda_stream, child.cuda_stream,
                                   kind, flag.data_ptr(),
                                   ctypes.byref(handle)), "cond_begin")
        self.depth += 1
        try:
            with torch.cuda.stream(child):
                self.pools.begin(self.depth)
                try:
                    with kops.deferred_launches() as launches:
                        body()
                finally:
                    self.pools.end(self.depth)
                _check(self.lib.cond_end(
                    child.cuda_stream, handle,
                    flag.data_ptr() if kind == _WHILE else None), "cond_end")
        finally:
            self.depth -= 1
        self.scopes.append(("loop" if kind == _WHILE else "branch",
                            self.depth + 1, launches))

    def branch(self, flag, body):
        self._node(_IF, flag, body)

    def loop(self, flag, body):
        self._node(_WHILE, flag, body)
