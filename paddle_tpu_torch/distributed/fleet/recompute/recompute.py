"""Activation recompute; counterpart of
``paddle_tpu/distributed/fleet/recompute/recompute.py``.

:func:`recompute` runs a function without keeping its activations and
runs it again in the backward to rebuild them.  It is
``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)`` whatever
``use_reentrant`` says: torch's reentrant form computes no gradient for
the parameters a closure captures when no explicit input requires one,
while the reference's replay accumulates them (its custom VJP runs the
closure's backward).  The non-reentrant form records the forward's graph
and refills its saved tensors in the backward, so every leaf the
function reaches gets its gradient, once, from the original graph.

The port's amp state (``amp.auto_cast``) is a module state, not
``torch.autocast``, so torch does not replay it: the recomputation runs
under the state the forward ran under, though the backward runs outside
the ``auto_cast`` block.

Random bits: the port draws dropout from explicit ``torch.Generator``
objects (a model's own, ``device.generator``), not from one global key.
``preserve_rng_state=True`` replays the forward's bits in the
recomputation: with ``generator`` given, the recomputation runs from the
state that generator had when the forward started and hands it back
where it was after; without it, torch's own ``preserve_rng_state``
does the same for the global CPU and CUDA generators.
"""
from __future__ import annotations

from torch.utils.checkpoint import checkpoint

from .... import amp

__all__ = ["recompute", "recompute_sequential", "recompute_hybrid"]


def recompute(function, *args, generator=None, **kwargs):
    """ref: ``fleet.recompute(function, *args, preserve_rng_state=True,
    use_reentrant=True, **kwargs)``: ``function(*args, **kwargs)`` with
    its activations recomputed in the backward (module docstring).
    ``generator`` names the ``torch.Generator`` whose state the
    recomputation replays."""
    preserve = kwargs.pop("preserve_rng_state", True)
    kwargs.pop("use_reentrant", True)
    amp_state = amp._current()
    replay = generator if preserve else None
    start = replay.get_state() if replay is not None else None
    first = [True]

    def run(*a, **kw):
        if first[0]:
            first[0] = False
            return function(*a, **kw)
        now = replay.get_state() if replay is not None else None
        if replay is not None:
            replay.set_state(start)
        try:
            with amp._restored(amp_state):
                return function(*a, **kw)
        finally:
            if replay is not None:
                replay.set_state(now)

    return checkpoint(run, *args, use_reentrant=False,
                      preserve_rng_state=preserve and generator is None,
                      **kwargs)


def recompute_sequential(ctx, functions, *args, **kwargs):
    """ref: ``recompute_sequential``: the layers of ``functions`` (a
    ``Sequential`` or a list) in ``ctx["segments"]`` consecutive groups
    of ``ceil(n / segments)``, each group recomputed as one;
    ``ctx["preserve_rng_state"]`` (default True) goes to each."""
    segments = ctx.get("segments", 1) if isinstance(ctx, dict) else 1
    preserve = ctx.get("preserve_rng_state", True) \
        if isinstance(ctx, dict) else True
    if hasattr(functions, "children"):
        functions = list(functions.children())
    functions = list(functions)
    per = -(-len(functions) // max(segments, 1))
    x = args[0] if len(args) == 1 else args

    def run_segment(fns):
        def seg(*xs):
            y = xs[0] if len(xs) == 1 else xs
            for f in fns:
                y = f(*y) if isinstance(y, tuple) else f(y)
            return y
        return seg

    for i in range(0, len(functions), per):
        seg = run_segment(functions[i:i + per])
        xs = x if isinstance(x, tuple) else (x,)
        x = recompute(seg, *xs, preserve_rng_state=preserve, **kwargs)
    return x


def recompute_hybrid(ctx, function, *args, **kwargs):
    """ref: ``recompute_hybrid``: :func:`recompute` of ``function``; the
    reference partitions the saved activations over its model-parallel
    group, which the port does not have yet, and drops
    ``offload_indices``, as the reference does."""
    kwargs.pop("offload_indices", None)
    return recompute(function, *args, **kwargs)
