"""Functional graph transforms over captured ``Program`` op lists;
counterpart of ``paddle_tpu/static/passes/graph.py``.

The Program IR (static/capture.py) is an SSA-ish op trace: each
``_OpRecord`` holds the replay fn, its non-tensor arguments (``kwargs``,
tensors replaced by slots), and strong refs to the input/output tensors;
tensor *identity* (``id``) is the edge.  Every transform here is
FUNCTIONAL — it returns a new op list built from new ``_OpRecord``
instances where rewiring is needed and NEVER mutates a record in place (a
mutated record would silently corrupt the original Program and every
clone sharing it).

Soundness model:

* CSE may only merge two ops when they are *provably* the same
  computation: the key holds the op name, the replay fn's code object with
  its closure cell values and defaults (structurally hashed), the input
  ids, and the record's non-tensor arguments (slices, shapes, dims,
  scalars).  Two ``getitem`` records with different slices or two
  ``multiply`` records with different factors never merge.  Anything that
  cannot be hashed conservatively opts out, as does an op that draws
  random bits (by name, or holding a ``torch.Generator``).
* Constant folding relies on a capture-time invariant: ops execute
  eagerly during capture, so every recorded output tensor already holds
  its value.  An op whose inputs are all true constants (never produced,
  not placeholders, not ``nn.Parameter``s, not registered buffers of a
  module that ran during capture, not writeback targets) can simply be
  DROPPED — consumers then read the output tensor as a replay external,
  which is exactly the folded value.
* Fusion composes a single-consumer producer into its consumer: the
  producer's fn runs inside the consumer's composite at the consumer's
  position.  For pure SSA traces this reordering is unobservable; the
  replayed record count drops by one per composition (the torch calls
  stay the same).
* Everything bails out (returns the input unchanged) when the trace is
  not SSA (a tensor id produced twice, or used before produced): those
  traces encode mutation patterns whose replay is position-sensitive.
"""
from __future__ import annotations

import hashlib
from typing import Any, Callable, Dict, List, Optional, Sequence, Set, Tuple

import torch

from ...ops import fused_decode as _fd
from ..capture import _OpRecord, _Slot

# ops whose replay draws on randomness: never CSE'd or folded (merging or
# folding would silently correlate or freeze samples).  Fusion is fine —
# the fn still runs verbatim.
IMPURE_NAMES = frozenset({
    "dropout", "uniform", "uniform_", "randint", "randn", "rand",
    "normal", "gaussian", "bernoulli", "multinomial", "randperm",
    "exponential", "exponential_", "poisson", "standard_normal", "rrelu",
    "rand_like", "randn_like", "randint_like", "normal_", "bernoulli_",
})

# ops a fused composite must never absorb or be absorbed into: compiled
# chains, collectives (ordering is a distributed contract), and the
# static-grad op.
FUSE_BARRIER_NAMES = frozenset({
    "to_static", "sot_segment", "grad", "all_reduce", "all_gather",
    "reduce_scatter", "broadcast", "alltoall", "send", "recv",
    "sharding_constraint",
})

# cheap-to-recompute op classes: candidates for remat hints when their
# output feeds several consumers (recomputing beats materializing)
CHEAP_RECOMPUTE_NAMES = frozenset({
    "add", "subtract", "multiply", "scale", "cast", "astype", "reshape",
    "transpose", "concat", "getitem", "relu", "gelu", "silu", "tanh",
    "sigmoid", "layer_norm", "rms_norm", "fused_rms_norm", "softmax",
    "dropout",
})

_NORM_NAMES = frozenset({"layer_norm", "rms_norm", "fused_rms_norm"})
_MATMUL_NAMES = frozenset({"matmul", "mm", "linear", "addmm", "bmm"})
_ROPE_NAMES = frozenset({"fused_rotary_position_embedding", "rope",
                         "rotary_position_embedding", "fused_rope"})

CLAIMED_BY = "ops.fused_decode.norm_matmul"


def op_display_name(op: _OpRecord) -> str:
    return op.name or getattr(op.fn, "__name__", "op")


# ---------------------------------------------------------------------------
# op classification
# ---------------------------------------------------------------------------

_CLASS_TABLE = (
    ("matmul", _MATMUL_NAMES | {"conv2d", "conv1d", "conv3d", "einsum"}),
    ("attention", {"scaled_dot_product_attention", "flash_attention",
                   "paged_attention", "memory_efficient_attention"}),
    ("norm", _NORM_NAMES | {"batch_norm", "group_norm", "instance_norm"}),
    ("embedding", {"embedding", "one_hot"}),
    ("reduction", {"sum", "mean", "max", "min", "prod", "logsumexp",
                   "argmax", "argmin", "all", "any", "norm", "std",
                   "var", "cross_entropy", "softmax_with_cross_entropy"}),
    ("layout", {"reshape", "transpose", "concat", "split", "getitem",
                "setitem", "stack", "squeeze", "unsqueeze", "flatten",
                "tile", "expand", "gather", "scatter", "pad", "roll",
                "slice"}),
    ("random", IMPURE_NAMES),
    ("compiled", {"to_static", "sot_segment", "grad"}),
    ("collective", {"all_reduce", "all_gather", "reduce_scatter",
                    "broadcast", "alltoall", "send", "recv"}),
)


def op_class(name: str) -> str:
    """Bucket an op name into the coarse class taxonomy."""
    base = (name or "op").split("+")[0]
    for cls, names in _CLASS_TABLE:
        if base in names:
            return cls
    return "elementwise"


def op_class_histogram(ops: Sequence[_OpRecord]) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for op in ops:
        # a fused composite counts every constituent op toward its class
        for part in op_display_name(op).split("+"):
            c = op_class(part)
            out[c] = out.get(c, 0) + 1
    return out


def op_class_delta(before: Sequence[_OpRecord],
                   after: Sequence[_OpRecord]) -> Dict[str, int]:
    """after-minus-before per-class op counts (fused parts unrolled)."""
    b, a = op_class_histogram(before), op_class_histogram(after)
    return {k: a.get(k, 0) - b.get(k, 0)
            for k in sorted(set(b) | set(a))
            if a.get(k, 0) != b.get(k, 0)}


# ---------------------------------------------------------------------------
# SSA check — the precondition every transform requires
# ---------------------------------------------------------------------------

def is_ssa(ops: Sequence[_OpRecord]) -> bool:
    """True iff no tensor id is produced twice and none is consumed
    before the op that produces it (both patterns make replay meaning
    depend on record position, which rewrites would scramble)."""
    first_prod: Dict[int, int] = {}
    for i, op in enumerate(ops):
        for t in op.outputs:
            if id(t) in first_prod:
                return False
            first_prod[id(t)] = i
    for i, op in enumerate(ops):
        for t in op.inputs:
            j = first_prod.get(id(t))
            if j is not None and j >= i:
                return False
    return True


def _consumer_map(ops: Sequence[_OpRecord]) -> Dict[int, List[int]]:
    """tensor id -> indices of ops that consume it (deduped per op)."""
    out: Dict[int, List[int]] = {}
    for i, op in enumerate(ops):
        for tid in {id(t) for t in op.inputs}:
            out.setdefault(tid, []).append(i)
    return out


def default_root_ids(program) -> Set[int]:
    """Liveness roots when no explicit fetch list exists (clone,
    PassBase.apply outside the pipeline): every writeback source, plus
    every op output that nothing consumes and no writeback feeds on —
    an unconsumed non-writeback output is a potential user fetch."""
    wb_sources = {id(src) for _, src in program.writebacks}
    consumed = {id(t) for op in program.ops for t in op.inputs}
    roots = set(wb_sources)
    for op in program.ops:
        for t in op.outputs:
            if id(t) not in consumed and id(t) not in wb_sources:
                roots.add(id(t))
    return roots


# ---------------------------------------------------------------------------
# structural hashing for CSE keys
# ---------------------------------------------------------------------------

_MAX_HASH_ELEMS = 1024
_ATOMS = (torch.dtype, torch.device, torch.layout, torch.memory_format)


def _value_key(v: Any, depth: int = 0) -> Any:
    if depth > 6:
        return ("id", id(v))
    if v is None or isinstance(v, (bool, int, float, complex, str, bytes)):
        return ("c", repr(v))
    if isinstance(v, _Slot):
        return ("slot", v.index)
    if isinstance(v, _ATOMS):
        return ("c", repr(v))
    if isinstance(v, (tuple, list)):
        return ("seq", type(v).__name__,
                tuple(_value_key(x, depth + 1) for x in v))
    if isinstance(v, dict):
        return ("map", tuple(sorted((repr(k), _value_key(x, depth + 1))
                                    for k, x in v.items())))
    if isinstance(v, slice):
        return ("slice", repr(v))
    if isinstance(v, torch.Tensor):
        if v.numel() <= _MAX_HASH_ELEMS:
            raw = v.detach().cpu().reshape(-1).contiguous().view(torch.uint8)
            return ("arr", tuple(v.shape), str(v.dtype),
                    hashlib.sha1(raw.numpy().tobytes()).hexdigest())
        return ("bigarr", id(v))
    if callable(v):
        return _callable_key(v, depth + 1)
    return ("id", id(v))


def _callable_key(fn: Callable, depth: int = 0) -> Optional[Any]:
    """Structural identity of a replay fn.  Two fns with equal keys
    compute the same function of their inputs; None means 'unknown —
    do not CSE'."""
    if depth > 4:
        return None
    code = getattr(fn, "__code__", None)
    if code is None:
        # builtin / torch method: object identity is the only safe notion
        return ("fobj", id(fn))
    try:
        cells = tuple(_value_key(c.cell_contents, depth + 1)
                      for c in (fn.__closure__ or ()))
    except ValueError:          # empty cell
        return None
    defaults = tuple(_value_key(d, depth + 1)
                     for d in (fn.__defaults__ or ()))
    kwdefaults = tuple(sorted(
        (k, _value_key(v, depth + 1))
        for k, v in (fn.__kwdefaults__ or {}).items()))
    return ("fn", id(code), cells, defaults, kwdefaults)


def _holds_generator(v: Any) -> bool:
    if isinstance(v, torch.Generator):
        return True
    if isinstance(v, (tuple, list)):
        return any(_holds_generator(u) for u in v)
    if isinstance(v, dict):
        return any(_holds_generator(u) for u in v.values())
    return False


def _impure(op: _OpRecord) -> bool:
    return op_display_name(op) in IMPURE_NAMES or _holds_generator(op.kwargs)


def _cse_key(op: _OpRecord, inputs: Sequence) -> Optional[Any]:
    if _impure(op):
        return None
    fkey = _callable_key(op.fn)
    if fkey is None:
        return None
    return (op_display_name(op), fkey, tuple(id(t) for t in inputs),
            _value_key(dict(op.kwargs)), bool(op.multi_out),
            len(op.outputs))


# ---------------------------------------------------------------------------
# the transforms
# ---------------------------------------------------------------------------

def run_cse(ops: Sequence[_OpRecord], root_ids: Set[int]
            ) -> Tuple[List[_OpRecord], int]:
    """Merge provably-identical ops; later duplicates are dropped and
    their consumers rewired onto the first occurrence's outputs.  Ops
    producing a root (fetched / writeback-source) tensor are kept — the
    replay fetch list addresses tensors by identity."""
    if not is_ssa(ops):
        return list(ops), 0
    seen: Dict[Any, _OpRecord] = {}
    repl: Dict[int, Any] = {}       # old tensor id -> replacement tensor
    out: List[_OpRecord] = []
    removed = 0
    for op in ops:
        new_inputs = [repl.get(id(t), t) for t in op.inputs]
        if any(n is not o for n, o in zip(new_inputs, op.inputs)):
            op = _OpRecord(op.fn, op.kwargs, new_inputs, op.outputs,
                           op.multi_out, op.name)
        key = _cse_key(op, op.inputs)
        if key is not None:
            prev = seen.get(key)
            if prev is not None and \
                    len(prev.outputs) == len(op.outputs) and \
                    not any(id(t) in root_ids for t in op.outputs):
                for old, new in zip(op.outputs, prev.outputs):
                    repl[id(old)] = new
                removed += 1
                continue
            if prev is None:
                seen[key] = op
        out.append(op)
    return out, removed


def run_constant_fold(ops: Sequence[_OpRecord], placeholder_ids: Set[int],
                      protected_ids: Set[int]
                      ) -> Tuple[List[_OpRecord], int]:
    """Drop pure ops whose inputs are all compile-time constants.  The
    outputs keep their capture-time values and become replay externals —
    the fold IS the eager value capture already computed.
    ``protected_ids`` are tensors whose value may change between runs
    (writeback targets, registered buffers); ``nn.Parameter``s are
    excluded by inspection."""
    if not is_ssa(ops):
        return list(ops), 0
    produced: Set[int] = set()       # outputs of KEPT ops
    folded_out: Set[int] = set()     # outputs of folded ops (constants)
    out: List[_OpRecord] = []
    removed = 0

    def is_const(t) -> bool:
        tid = id(t)
        if tid in folded_out:
            return True
        if tid in produced or tid in placeholder_ids or \
                tid in protected_ids:
            return False
        return not isinstance(t, torch.nn.Parameter)

    for op in ops:
        name = op_display_name(op)
        if not _impure(op) and name not in FUSE_BARRIER_NAMES \
                and op.inputs and all(is_const(t) for t in op.inputs):
            folded_out.update(id(t) for t in op.outputs)
            removed += 1
            continue
        out.append(op)
        produced.update(id(t) for t in op.outputs)
    return out, removed


def run_dce(ops: Sequence[_OpRecord], root_ids: Set[int]
            ) -> Tuple[List[_OpRecord], int]:
    """Drop ops whose outputs reach no root (fetch / writeback source)."""
    if not is_ssa(ops):
        return list(ops), 0
    needed = set(root_ids)
    kept_rev: List[_OpRecord] = []
    removed = 0
    for op in reversed(ops):
        if any(id(t) in needed for t in op.outputs):
            kept_rev.append(op)
            needed.update(id(t) for t in op.inputs)
        else:
            removed += 1
    kept_rev.reverse()
    return kept_rev, removed


def _fused_width(op: _OpRecord) -> int:
    return op_display_name(op).count("+") + 1


def _compose(prod: _OpRecord, cons: _OpRecord) -> _OpRecord:
    """One composite record running ``prod`` then ``cons`` (with prod's
    single output wired into every position it held in cons.inputs)."""
    t = prod.outputs[0]
    pfn, pkw, n_p = prod.fn, dict(prod.kwargs), len(prod.inputs)
    cfn, ckw = cons.fn, dict(cons.kwargs)
    # where each of cons's inputs comes from: -1 is prod's output, else its
    # place in the composite's inputs (prod's inputs, then cons's others)
    src, nxt = [], n_p
    for u in cons.inputs:
        if u is t:
            src.append(-1)
        else:
            src.append(nxt)
            nxt += 1
    src = tuple(src)

    def fused(*xs):
        a = pfn(*xs[:n_p], **pkw)
        return cfn(*[a if i < 0 else xs[i] for i in src], **ckw)

    new_inputs = list(prod.inputs) + [u for u in cons.inputs if u is not t]
    return _OpRecord(fused, {}, new_inputs, cons.outputs, cons.multi_out,
                     f"{op_display_name(prod)}+{op_display_name(cons)}")


def collect_fusion_hints(ops: Sequence[_OpRecord]) -> List[dict]:
    """Flag producer->consumer chains the fused kernels can claim
    (norm+matmul, rope+QKV-projection) — pattern annotations,
    independent of whether the rewrite fuses them."""
    producer: Dict[int, int] = {}
    for i, op in enumerate(ops):
        for t in op.outputs:
            producer[id(t)] = i
    hints: List[dict] = []
    for j, op in enumerate(ops):
        cname = op_display_name(op)
        for t in op.inputs:
            i = producer.get(id(t))
            if i is None:
                continue
            pname = op_display_name(ops[i])
            pparts, cparts = set(pname.split("+")), set(cname.split("+"))
            kind = None
            if pparts & _NORM_NAMES and cparts & _MATMUL_NAMES:
                kind = "norm_matmul"
            elif (pparts & _MATMUL_NAMES and cparts & _ROPE_NAMES) or \
                    (pparts & _ROPE_NAMES and cparts & _MATMUL_NAMES):
                kind = "rope_qkv"
            if kind:
                hints.append({"kind": kind, "ops": [i, j],
                              "chain": f"{pname}->{cname}",
                              "claimable_by": "ops.fused_decode"})
    return hints


def run_fuse(ops: Sequence[_OpRecord], root_ids: Set[int],
             max_width: int = 8) -> Tuple[List[_OpRecord], int]:
    """Compose single-consumer producer->consumer chains into composite
    records (replayed-record-count reduction; the same torch calls run).
    A producer is absorbable iff it has exactly one output, that output
    is consumed by exactly one op and is not a root, and neither side
    is a barrier op.  Runs to fixpoint so chains collapse fully."""
    if not is_ssa(ops):
        return list(ops), 0
    ops = list(ops)
    total = 0
    while True:
        producer: Dict[int, int] = {}
        for i, op in enumerate(ops):
            for t in op.outputs:
                producer[id(t)] = i
        consumers = _consumer_map(ops)
        absorbed: Dict[int, int] = {}    # producer idx -> consumer idx
        busy: Set[int] = set()           # ops already part of a fusion
        for j, op in enumerate(ops):
            if j in busy:
                continue
            cname = op_display_name(op)
            if set(cname.split("+")) & FUSE_BARRIER_NAMES:
                continue
            for t in op.inputs:
                i = producer.get(id(t))
                if i is None or i in busy or i == j:
                    continue
                prod = ops[i]
                pname = op_display_name(prod)
                if (prod.multi_out or len(prod.outputs) != 1
                        or set(pname.split("+")) & FUSE_BARRIER_NAMES
                        or id(t) in root_ids
                        or consumers.get(id(t), []) != [j]
                        or _fused_width(prod) + _fused_width(op)
                        > max_width):
                    continue
                absorbed[i] = j
                busy.add(i)
                busy.add(j)
                break
        if not absorbed:
            return ops, total
        by_consumer = {j: i for i, j in absorbed.items()}
        out: List[_OpRecord] = []
        for j, op in enumerate(ops):
            if j in absorbed:            # moved into its consumer
                continue
            i = by_consumer.get(j)
            out.append(_compose(ops[i], op) if i is not None else op)
        ops = out
        total += len(absorbed)


def claimed_norm_matmul(*xs, kind: str, epsilon: float,
                        has_norm_bias: bool, transpose_y: bool,
                        has_mm_bias: bool):
    """Replay fn of a claimed norm->matmul chain, over the norm's inputs
    then the matmul's others: ``ops.fused_decode.norm_matmul`` (K6d on
    the card where its gate admits the shapes).  A ``transpose_y`` weight
    goes in as a transposed view, never a copy."""
    n_norm = 3 if has_norm_bias else 2
    x, nw = xs[0], xs[1]
    nb = xs[2] if has_norm_bias else None
    w = xs[n_norm]
    bias = xs[n_norm + 1] if has_mm_bias else None
    if transpose_y:
        w = w.transpose(-1, -2)
    return _fd.norm_matmul(x, nw, nb, w, bias, kind=kind, eps=epsilon)


def _last_axis_only(normalized_shape, x) -> bool:
    if isinstance(normalized_shape, int):
        normalized_shape = [normalized_shape]
    return list(normalized_shape) == [x.shape[-1]]


def _claim_norm_matmul(prod: _OpRecord, cons: _OpRecord,
                       consumers: Dict[int, List[int]], j: int,
                       root_ids: Set[int]) -> Optional[_OpRecord]:
    """Build the fused-kernel record for a flagged norm→matmul chain,
    or None when the chain's parameters can't be recovered from the
    records.  The candidate is validated NUMERICALLY against the
    capture-time output values before it is accepted — a wrong reading of
    a record can never silently change replay semantics.  A claim is
    refused only by the records (shape, dtype, arguments) or by that
    check; an error of the kernel (its build, its launch) propagates."""
    if prod.multi_out or len(prod.outputs) != 1 or cons.multi_out:
        return None
    t = prod.outputs[0]
    if id(t) in root_ids or consumers.get(id(t), []) != [j]:
        return None
    if not cons.inputs or cons.inputs[0] is not t \
            or any(u is t for u in cons.inputs[1:]):
        return None
    pname, cname = op_display_name(prod), op_display_name(cons)
    eps = prod.kwargs.get("epsilon")
    if isinstance(eps, bool) or not isinstance(eps, (int, float)):
        return None
    if pname == "layer_norm":
        kind, has_norm_bias = "layer_norm", True
        if len(prod.inputs) != 3:         # weight+bias is the hot shape
            return None
        if not _last_axis_only(prod.kwargs.get("normalized_shape"),
                               prod.inputs[0]):
            return None
    elif pname == "rms_norm":
        kind, has_norm_bias = "rms_norm", False
        if len(prod.inputs) != 2:         # a trailing bias-add opts out
            return None
    else:
        return None
    if cname == "matmul":
        if len(cons.inputs) != 2:
            return None
        if cons.kwargs.get("transpose_x") is True:
            return None
        transpose_y = cons.kwargs.get("transpose_y") is True
        has_mm_bias = False
    elif cname == "linear":
        if len(cons.inputs) not in (2, 3):
            return None
        transpose_y = False
        has_mm_bias = len(cons.inputs) == 3
    else:
        return None
    if cons.inputs[1].dim() != 2:
        return None
    kwargs = dict(kind=kind, epsilon=float(eps),
                  has_norm_bias=has_norm_bias, transpose_y=transpose_y,
                  has_mm_bias=has_mm_bias)
    inputs = list(prod.inputs) + list(cons.inputs[1:])
    if any(u.dtype != inputs[0].dtype for u in inputs[1:]):
        return None                       # K6d takes one dtype
    # no try: a kernel that fails to build or launch raises here, it
    # never turns into a quietly refused claim
    with torch.no_grad():
        got = claimed_norm_matmul(*inputs, **kwargs)
    want = cons.outputs[0]
    if got.shape != want.shape or got.dtype != want.dtype or \
            not torch.allclose(got, want, rtol=1e-4, atol=1e-5):
        return None
    return _OpRecord(claimed_norm_matmul, kwargs, inputs, cons.outputs,
                     cons.multi_out, f"{pname}+{cname}")


def run_claim_fused_kernels(ops: Sequence[_OpRecord],
                            root_ids: Set[int]
                            ) -> Tuple[List[_OpRecord], List[dict]]:
    """Rewrite flagged norm→matmul ``fusion_hints`` chains onto the
    fused ``norm_matmul`` kernel record.  Each accepted claim drops the
    norm record and replaces the matmul record with one fused record
    whose replay routes through ``ops.fused_decode.norm_matmul``.
    Returns the rewritten op list and the hint dicts that were claimed
    (annotated ``claimed=True`` — they join ``Program.fusion_hints`` so
    the annotation surface still describes every captured chain)."""
    if not is_ssa(ops):
        return list(ops), []
    consumers = _consumer_map(ops)
    claimed: Dict[int, int] = {}          # producer idx -> consumer idx
    claimed_hints: List[dict] = []
    new_records: Dict[int, _OpRecord] = {}
    busy: Set[int] = set()
    for h in collect_fusion_hints(ops):
        if h["kind"] != "norm_matmul":
            continue
        i, j = h["ops"]
        if i in busy or j in busy:
            continue
        rec = _claim_norm_matmul(ops[i], ops[j], consumers, j, root_ids)
        if rec is None:
            continue
        claimed[i] = j
        claimed_hints.append(dict(h, claimed=True, claimed_by=CLAIMED_BY))
        new_records[j] = rec
        busy.update((i, j))
    if not claimed:
        return list(ops), []
    out = [new_records.get(k, op) for k, op in enumerate(ops)
           if k not in claimed]
    return out, claimed_hints


def collect_remat_hints(ops: Sequence[_OpRecord]) -> List[dict]:
    """Cheap ops whose output feeds >=2 consumers: recompute-in-place
    candidates for a checkpoint policy."""
    consumers = _consumer_map(ops)
    hints = []
    for i, op in enumerate(ops):
        name = op_display_name(op)
        if set(name.split("+")) & CHEAP_RECOMPUTE_NAMES:
            for t in op.outputs:
                n = len(consumers.get(id(t), ()))
                if n >= 2:
                    hints.append({"kind": "remat", "op": i, "name": name,
                                  "consumers": n})
                    break
    return hints


def collect_donation_hints(program) -> List[dict]:
    """Writeback targets double as replay externals: their input buffer
    dies the moment the new value commits — a replay may reuse it."""
    hints = []
    for target, _src in program.writebacks:
        hints.append({"kind": "donate",
                      "external": program.var_name(target)
                      or f"tensor@{id(target)}",
                      "reason": "writeback target buffer is dead after "
                                "the step commits"})
    return hints
