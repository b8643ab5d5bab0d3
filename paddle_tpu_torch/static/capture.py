"""Static-graph capture: the Program IR; counterpart of
``paddle_tpu/static/capture.py`` (ref: paddle/fluid/framework/
ProgramDesc + python/paddle/base/framework.py Program/Block).

A Program is an op trace recorded while the ops run eagerly, replayed as
a function of its feeds and its external tensors.  Running eagerly during
capture is what the passes rely on: every recorded output already holds
its value, so constant folding can drop an op and keep its output as a
replay external, and a kernel claim can be checked against the captured
values.  Ops are recorded at two layers:

* named ops — each public op of ``nn.functional`` and
  ``incubate.nn.functional`` (decorated with :func:`recorded`) records one
  op under the name the JAX dispatch gives it (``layer_norm``, ``linear``,
  ``matmul``, ``embedding``, ``rms_norm``, ``fused_rope``, ...).  The
  torch calls inside it (amp casts, kernel wrappers) belong to it and are
  not recorded;
* raw tensor ops — a ``TorchFunctionMode`` records the tensor ops that
  model code calls itself (``reshape``, ``__getitem__``, ``cat``, ``+``,
  ``*``, ``arange``, ...) under the JAX names (``reshape``, ``getitem``,
  ``concat``, ``add``, ``multiply``, ``arange``).

A record keeps every non-tensor argument (shapes, slices, dims, scalars,
``epsilon``, ``transpose_y``) in its ``kwargs``, each tensor argument
replaced by a :class:`_Slot` that names its place in ``inputs``; the
passes key common subexpressions on them and read them.  Not recorded:
calls that return no tensor (``.shape``, ``.dim()``, ``.data_ptr()``) and
calls that return one of their inputs unchanged (eval-mode ``dropout``,
``.contiguous()`` of a contiguous tensor): the value flows on as the same
tensor.  An in-place op is recorded with the mutated tensor as its
output, so the trace is no longer SSA and every pass leaves it alone.

Capture is per thread: another thread's ops are not recorded.
"""
from __future__ import annotations

import contextlib
import functools
import inspect
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
from torch.nn.modules.module import register_module_forward_pre_hook
from torch.overrides import TorchFunctionMode

__all__ = ["Program", "capture_ops", "recorded"]


class _OpRecord:
    __slots__ = ("fn", "kwargs", "inputs", "outputs", "multi_out", "name")

    def __init__(self, fn, kwargs, inputs, outputs, multi_out, name):
        self.fn = fn              # fn(*inputs, **kwargs) -> output(s)
        self.kwargs = kwargs
        self.inputs = inputs      # list[Tensor] (strong refs — the
        self.outputs = outputs    # Program owns its graph tensors)
        self.multi_out = multi_out
        self.name = name


class _Slot:
    """Stands for ``inputs[index]`` in a record's ``kwargs``."""

    __slots__ = ("index",)

    def __init__(self, index: int):
        self.index = index

    def __repr__(self):
        return f"<input {self.index}>"


def _template(v, tensors: List[torch.Tensor]):
    """``v`` with each tensor appended to ``tensors`` and replaced by its
    slot (through tuples, lists and dicts)."""
    if isinstance(v, torch.Tensor):
        tensors.append(v)
        return _Slot(len(tensors) - 1)
    if type(v) in (tuple, list):
        return type(v)(_template(u, tensors) for u in v)
    if type(v) is dict:
        return {k: _template(u, tensors) for k, u in v.items()}
    return v


def _fill(v, tensors: Sequence[torch.Tensor]):
    """The inverse of :func:`_template` against ``tensors``."""
    if isinstance(v, _Slot):
        return tensors[v.index]
    if type(v) in (tuple, list):
        return type(v)(_fill(u, tensors) for u in v)
    if type(v) is dict:
        return {k: _fill(u, tensors) for k, u in v.items()}
    return v


def _named_replay(func: Callable) -> Callable:
    """Replay fn of a named op: its arguments by parameter name."""
    def replay(*tensors, **arguments):
        return func(**_fill(arguments, tensors))
    return replay


def _raw_replay(func: Callable) -> Callable:
    def replay(*tensors, args, kwargs):
        return func(*_fill(args, tensors), **_fill(kwargs, tensors))
    return replay


def _outputs(out) -> Optional[List[torch.Tensor]]:
    """The tensors a call returned, or None when it returned none."""
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (tuple, list)):
        ts = [o for o in out if isinstance(o, torch.Tensor)]
        if ts and len(ts) != len(out):
            raise TypeError("cannot record a call that returns tensors "
                            "mixed with other values")
        return ts or None
    return None


class Program:
    """ref: base/framework.py Program."""

    _counter = 0

    def __init__(self):
        Program._counter += 1
        self._id = Program._counter
        self.ops: List[_OpRecord] = []
        self.placeholders: Dict[str, torch.Tensor] = {}
        # (target, source) pairs whose source value is written into the
        # target after a run (optimizer updates in a training program)
        self.writebacks: List = []
        # annotations written by the pass pipeline (static.passes):
        # per-pass op-count stats, the norm->matmul chains the kernels
        # can claim, remat and donation placement hints
        self.pass_log: List[dict] = []
        self.fusion_hints: List[dict] = []
        self.remat_hints: List[dict] = []
        self.donation_hints: List[dict] = []
        # registered buffers of the modules that ran during capture, by
        # id: state that may change between runs, never folded
        self.buffers: Dict[int, torch.Tensor] = {}
        # names given to tensors with name_var (torch tensors carry none)
        self.var_names: Dict[int, str] = {}

    # -- capture ---------------------------------------------------------
    def _record_call(self, fn, kwargs: dict, inputs, out, name: str,
                     mutated: Optional[torch.Tensor] = None) -> None:
        if mutated is not None:
            outs, multi = [mutated], False
        else:
            outs = _outputs(out)
            if outs is None:
                return
            ins = {id(t) for t in inputs}
            if any(id(o) in ins for o in outs):
                return              # returned an input: nothing to replay
            multi = not isinstance(out, torch.Tensor)
        self.ops.append(_OpRecord(fn, kwargs, list(inputs), outs, multi,
                                  name))

    def _note_module(self, module, args):
        for b in module.buffers(recurse=False):
            self.buffers[id(b)] = b

    def add_placeholder(self, name: str, t: torch.Tensor):
        self.placeholders[name] = t

    def name_var(self, t: torch.Tensor, name: str) -> torch.Tensor:
        """Give ``t`` (an op output or an external) a name that
        ``find_var_by_name`` resolves."""
        self.var_names[id(t)] = name
        return t

    def var_name(self, t: torch.Tensor) -> Optional[str]:
        for name, p in self.placeholders.items():
            if p is t:
                return name
        return self.var_names.get(id(t))

    # -- introspection (reference API) -----------------------------------
    def all_parameters(self):
        seen, out = set(), []
        for op in self.ops:
            for t in op.inputs:
                if isinstance(t, torch.nn.Parameter) and id(t) not in seen:
                    seen.add(id(t))
                    out.append(t)
        return out

    def find_var_by_name(self, name: str):
        if name in self.placeholders:
            return self.placeholders[name]
        for t in self.list_vars():
            if self.var_names.get(id(t)) == name:
                return t
        return None

    def list_vars(self):
        # placeholders AND op-produced vars: the surface find_var_by_name
        # resolves
        seen = {id(t) for t in self.placeholders.values()}
        out = list(self.placeholders.values())
        for op in self.ops:
            for t in op.outputs:
                if id(t) not in seen:
                    seen.add(id(t))
                    out.append(t)
        return out

    def _copy(self) -> "Program":
        p = Program()
        p.ops = list(self.ops)
        p.placeholders = dict(self.placeholders)
        p.writebacks = list(self.writebacks)
        p.buffers = dict(self.buffers)
        p.var_names = dict(self.var_names)
        return p

    def clone(self, for_test: bool = False) -> "Program":
        p = self._copy()
        # a test clone serves inference: drop the write-backs AND the
        # update ops that exist only to feed them (dead-op elimination
        # against the outputs that are not write-back sources)
        if for_test and self.writebacks:
            from .passes.graph import default_root_ids, run_dce
            roots = default_root_ids(self)
            roots -= {id(src) for _, src in self.writebacks}
            p.ops, _ = run_dce(p.ops, roots)
        if for_test:
            p.writebacks = []
        return p

    def __repr__(self):
        return (f"Program(id={self._id}, ops={len(self.ops)}, "
                f"feeds={list(self.placeholders)})")

    # -- replay ----------------------------------------------------------
    def build_replay(self, feed_names: Sequence[str],
                     fetch_tensors: Sequence[torch.Tensor]):
        """Return ``(pure, externals)``: ``pure(feed_tensors,
        external_tensors)`` gives the fetch tensors.  Externals are the
        inputs produced outside the program (parameters, buffers,
        constants, a prefill's cache) and are passed at run time, so an
        update of a parameter is seen without a new capture.  A replay
        writes into no external.  It runs under the caller's grad mode."""
        # snapshot now: ops recorded later must not appear in it
        ops = list(self.ops)
        produced = set()
        feed_ids = {id(self.placeholders[n]) for n in feed_names
                    if n in self.placeholders}
        externals: List[torch.Tensor] = []
        ext_ids = {}
        for op in ops:
            for t in op.inputs:
                if id(t) not in produced and id(t) not in feed_ids and \
                        id(t) not in ext_ids:
                    ext_ids[id(t)] = len(externals)
                    externals.append(t)
            for t in op.outputs:
                produced.add(id(t))

        feed_pos = {id(self.placeholders[n]): i
                    for i, n in enumerate(feed_names)
                    if n in self.placeholders}

        def pure(feed_tensors, ext_tensors):
            env: Dict[int, Any] = {}
            for tid, i in feed_pos.items():
                env[tid] = feed_tensors[i]
            for tid, i in ext_ids.items():
                env[tid] = ext_tensors[i]
            for op in ops:
                ins = [env.get(id(t), t) for t in op.inputs]
                outs = op.fn(*ins, **op.kwargs)
                if op.multi_out:
                    for t, o in zip(op.outputs, outs):
                        env[id(t)] = o
                else:
                    env[id(op.outputs[0])] = outs
            return tuple(env.get(id(ft), ft) for ft in fetch_tensors)

        return pure, externals


# ---------------------------------------------------------------------------
# recording
# ---------------------------------------------------------------------------

class _State(threading.local):
    def __init__(self):
        self.programs: List[Program] = []
        self.depth = 0              # > 0 while a named op runs


_state = _State()


def current_program() -> Optional[Program]:
    return _state.programs[-1] if _state.programs else None


def recorded(name: str):
    """Decorator of a public op: under :func:`capture_ops` one call
    records one op named ``name``, its tensor arguments as inputs and the
    others (defaults applied) in its ``kwargs`` by parameter name."""
    def deco(func):
        sig = inspect.signature(func)
        for p in sig.parameters.values():
            if p.kind in (p.VAR_POSITIONAL, p.VAR_KEYWORD,
                          p.POSITIONAL_ONLY):
                raise TypeError(f"{func.__name__}: a recorded op takes "
                                "its arguments by name")
        replay = _named_replay(func)

        @functools.wraps(func)
        def op(*args, **kwargs):
            prog = current_program()
            if prog is None or _state.depth:
                return func(*args, **kwargs)
            bound = sig.bind(*args, **kwargs)
            bound.apply_defaults()
            _state.depth += 1
            try:
                out = func(*args, **kwargs)
            finally:
                _state.depth -= 1
            inputs: List[torch.Tensor] = []
            arguments = _template(dict(bound.arguments), inputs)
            prog._record_call(replay, arguments, inputs, out, name)
            return out
        return op
    return deco


# torch names -> the JAX dispatch's names (reversed operators of
# non-commutative ops keep names of their own: their first input is the
# right operand)
_RAW_NAMES = {
    "__getitem__": "getitem", "__setitem__": "setitem", "cat": "concat",
    "concatenate": "concat", "__add__": "add",
    "__radd__": "add", "sub": "subtract", "__sub__": "subtract",
    "mul": "multiply", "__mul__": "multiply", "__rmul__": "multiply",
    "div": "divide", "__truediv__": "divide", "__rsub__": "rsub",
    "__rtruediv__": "rdivide", "__rmatmul__": "rmatmul",
    "__matmul__": "matmul", "view": "reshape", "float": "cast",
    "to": "cast", "type": "cast", "permute": "transpose", "__neg__": "neg",
}
_INPLACE_DUNDERS = frozenset({
    "__iadd__", "__isub__", "__imul__", "__itruediv__", "__ifloordiv__",
    "__imod__", "__ipow__", "__iand__", "__ior__", "__ixor__",
    "__ilshift__", "__irshift__", "__imatmul__", "__setitem__"})
# named ops whose records the kernel-claim pass reads by parameter name:
# a raw torch function of the same name takes other arguments (torch's
# F.linear an [out, in] weight), so it is recorded as torch_<name>
_CLAIM_READ = frozenset({"layer_norm", "rms_norm", "linear"})


def _torch_name(func) -> str:
    name = getattr(func, "__name__", None) or type(func).__name__
    if name == "__get__":                # a property: Tensor.T, .data
        name = getattr(getattr(func, "__self__", None), "__name__", name)
    return name


class _RecordMode(TorchFunctionMode):
    """Records the raw tensor ops of model code into ``program`` while no
    named op runs."""

    def __init__(self, program: Program):
        super().__init__()
        self.program = program

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if _state.depth == 0 and current_program() is self.program:
            self._record(func, args, kwargs, out)
        return out

    def _record(self, func, args, kwargs, out):
        tname = _torch_name(func)
        name = _RAW_NAMES.get(tname, tname)
        if name in _CLAIM_READ:
            name = "torch_" + name
        mutated = None
        if "out" in kwargs and isinstance(kwargs["out"], torch.Tensor):
            mutated = kwargs["out"]
        elif tname in _INPLACE_DUNDERS or (
                tname.endswith("_") and not tname.startswith("__")):
            mutated = args[0] if args and isinstance(
                args[0], torch.Tensor) else None
        if mutated is None and _outputs(out) is None:
            return
        inputs: List[torch.Tensor] = []
        kw = {"args": _template(tuple(args), inputs),
              "kwargs": _template(dict(kwargs), inputs)}
        self.program._record_call(_raw_replay(func), kw, inputs, out, name,
                                  mutated)


@contextlib.contextmanager
def capture_ops(program: Program):
    """Record every op run in this thread into ``program`` for the
    duration of the block (named ops and raw tensor ops), and note the
    registered buffers of every module that runs."""
    _state.programs.append(program)
    hook = register_module_forward_pre_hook(program._note_module)
    try:
        with _RecordMode(program):
            yield program
    finally:
        hook.remove()
        _state.programs.pop()
