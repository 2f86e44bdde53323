"""The cone projections' fixed-count loops as CUDA graphs on the card.

The JAX package's box, exponential and power projections are masked
loops of a fixed number of steps (25 Newton steps for the box; a bracket,
20 Newton and 40 bisection steps for exp; 20 Newton steps for power, on
two branches) that XLA compiles into one fused program. Run eagerly, each
step of each loop is a handful of kernel launches: a few thousand for one
projection, far more host time than the card spends on them.

`run(fn, args)` runs fn(*args) (tensors, or None) eagerly on the CPU. On
the card it replays a CUDA graph of fn captured once for the arguments'
shapes and dtypes: the arguments are copied into the graph's static input
buffers, the graph is replayed (one launch from the host), and its
outputs are copied out. The capture runs on a side stream after one
warm-up call, as the indirect backend's `_CGGraph` does; the graphs are
kept in a bounded cache. fn must read nothing but its arguments and must
not read the device from the host (no `.item()`, no Python `if` on a
tensor, no `nonzero`); a capture that fails raises, and nothing falls
back to eager on the card.

On the CPU a loop may stop once every entry has settled (`settled`): a
masked step leaves settled entries as they are, so the result is the
full loop's, bit for bit, and the CPU's plain version skips the steps
that would change nothing. On the card `settled` is always False, so the
loops keep their fixed count and read nothing from the host.

`captures` and `replays` count the graphs captured and replayed since the
counts were last set to 0.
"""

from __future__ import annotations

from collections import OrderedDict

import torch

GRAPH_CACHE_SIZE = 64

captures = 0
replays = 0


def settled(done: torch.Tensor) -> bool:
    """True when every entry of a CPU tensor `done` is set; False for a
    CUDA tensor, whose loop runs all its steps without a host read."""
    return not done.is_cuda and bool(done.all())


class _ConeGraph:
    """fn captured over static copies of one set of arguments."""

    def __init__(self, fn, args):
        dev = next(t.device for t in args if t is not None)
        self.inputs = tuple(None if t is None else t.clone() for t in args)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            # warm-up on copies (library set-up may not happen during a
            # capture); the captured call itself runs only on replay
            fn(*(None if t is None else t.clone() for t in args))
            self.graph = torch.cuda.CUDAGraph()
            self.graph.capture_begin()
            try:
                out = fn(*self.inputs)
            finally:
                self.graph.capture_end()
        torch.cuda.current_stream(dev).wait_stream(side)
        self.single = isinstance(out, torch.Tensor)
        self.outputs = (out,) if self.single else tuple(out)

    def __call__(self, args):
        for buf, t in zip(self.inputs, args):
            if buf is not None:
                buf.copy_(t)
        self.graph.replay()
        out = tuple(o.clone() for o in self.outputs)
        return out[0] if self.single else out


_graphs: "OrderedDict[tuple, _ConeGraph]" = OrderedDict()


def _key(fn, args) -> tuple:
    return (fn,) + tuple(None if t is None else
                         (tuple(t.shape), t.dtype, t.device) for t in args)


def run(fn, args: tuple):
    """fn(*args), replayed from a cached CUDA graph when the arguments lie
    on the card (see the module docstring)."""
    global captures, replays
    first = next(t for t in args if t is not None)
    if not first.is_cuda:
        return fn(*args)
    key = _key(fn, args)
    g = _graphs.pop(key, None)
    if g is None:
        g = _ConeGraph(fn, args)
        captures += 1
        while len(_graphs) >= GRAPH_CACHE_SIZE:
            _graphs.popitem(last=False)
    _graphs[key] = g
    replays += 1
    return g(args)
