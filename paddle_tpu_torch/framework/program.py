"""Program IR: the serializable graph-program representation.

Counterpart of paddle_tpu/framework/program.py (the reference's
ProgramDesc/BlockDesc/OpDesc/VarDesc plane, python/paddle/fluid/framework.py
Variable/Operator/Block/Program/Parameter).  The JSON written by
``to_dict`` is the JAX package's format, field for field, so a program
saved by either package loads into the other.

Here the Executor interprets the ops eagerly, one registered torch
lowering per op; the IR is the same program-as-data either way.
"""
from __future__ import annotations

import contextlib
import copy
import itertools
import os
import sys
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from ..core.dtypes import convert_dtype
from ..core.enforce import check_arg
from . import unique_name

# top-level keys of Program.to_dict this package writes itself; any other
# key (the JAX package's distributed-transpiler markers) is carried through
# clone/save/load untouched
_OWN_KEYS = ("version", "random_seed", "blocks")

GRAD_SUFFIX = "@GRAD"  # ref framework: core.grad_var_suffix()

# the package directory: frames under it are framework internals, the first
# frame outside it is the user's layer call site
_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _user_callsite() -> Optional[str]:
    """``file:line`` of the first stack frame outside the package: the
    layer call that appended the current op.  The verifier
    (paddle_tpu_torch/analysis) reports it with every finding, as the
    reference's ``op_callstack`` attr did.  None when every frame is
    internal."""
    try:
        f = sys._getframe(2)
    except ValueError:          # shallow stack
        return None
    depth = 0
    while f is not None and depth < 32:
        fn = f.f_code.co_filename
        if not fn.startswith(_PKG_DIR) and "importlib" not in fn:
            return f"{fn}:{f.f_lineno}"
        f = f.f_back
        depth += 1
    return None


def grad_var_name(name: str) -> str:
    return name + GRAD_SUFFIX


class Variable:
    """A named tensor slot in a Block.

    shape may contain -1 for data-dependent dims (batch); persistable vars
    live in the Scope across runs (parameters, optimizer state, BN stats).
    """

    def __init__(self, block: "Block", name: str, shape=None, dtype="float32",
                 persistable: bool = False, stop_gradient: bool = False,
                 is_data: bool = False, lod_level: int = 0):
        self.block = block
        self.name = name
        self.shape = tuple(int(s) for s in shape) if shape is not None else None
        self.dtype = convert_dtype(dtype)
        self.persistable = persistable
        self.stop_gradient = stop_gradient
        self.is_data = is_data
        self.lod_level = lod_level

    def __repr__(self):
        return (f"Variable(name={self.name!r}, shape={self.shape}, "
                f"dtype={self.dtype}, persistable={self.persistable})")

    def to_dict(self):
        d = {
            "name": self.name, "shape": list(self.shape or ()),
            "dtype": self.dtype, "persistable": self.persistable,
            "stop_gradient": self.stop_gradient, "is_data": self.is_data,
            "lod_level": self.lod_level,
            "is_parameter": isinstance(self, Parameter),
            "trainable": getattr(self, "trainable", None),
        }
        if getattr(self, "sharding", None) is not None:
            d["sharding"] = list(self.sharding)
        return d


class Parameter(Variable):
    """A trainable persistable Variable."""

    def __init__(self, block, name, shape, dtype="float32", trainable=True,
                 regularizer=None, **kw):
        check_arg(shape is not None and all(int(s) > 0 for s in shape),
                  f"Parameter {name!r} needs a fully-static shape, got {shape}")
        super().__init__(block, name, shape=shape, dtype=dtype,
                         persistable=True, **kw)
        self.trainable = trainable
        # ParamAttr.regularizer: minimize applies it in place of the
        # optimizer's own (not serialized, as in the JAX package)
        self.regularizer = regularizer
        # a PartitionSpec-style tuple written by the JAX package's
        # transpilers; carried through to_dict/from_dict unchanged
        self.sharding = None


class Operator:
    """One op invocation: (type, input/output var-name slots, attrs)."""

    def __init__(self, block: "Block", type: str,
                 inputs: Optional[Dict[str, Sequence[str]]] = None,
                 outputs: Optional[Dict[str, Sequence[str]]] = None,
                 attrs: Optional[Dict[str, Any]] = None):
        from .registry import get_op_def  # late import
        self.block = block
        self.type = type
        self.inputs = {k: list(v) for k, v in (inputs or {}).items()}
        self.outputs = {k: list(v) for k, v in (outputs or {}).items()}
        self.attrs = dict(attrs or {})
        # user-code origin for verifier findings; not serialized, so
        # to_dict stays the JAX package's format
        self.callsite = _user_callsite()
        get_op_def(type)  # validates the op exists

    def input_names(self) -> List[str]:
        return [n for vs in self.inputs.values() for n in vs]

    def output_names(self) -> List[str]:
        return [n for vs in self.outputs.values() for n in vs]

    def __repr__(self):
        return f"Op({self.type}, in={self.inputs}, out={self.outputs})"

    def to_dict(self):
        return {"type": self.type, "inputs": self.inputs,
                "outputs": self.outputs, "attrs": _jsonable_attrs(self.attrs)}


def _jsonable_attrs(attrs):
    out = {}
    for k, v in attrs.items():
        if isinstance(v, np.ndarray):
            out[k] = {"__ndarray__": v.tolist(), "dtype": str(v.dtype)}
        elif isinstance(v, np.integer):
            out[k] = int(v)
        elif isinstance(v, np.floating):
            out[k] = float(v)
        else:
            out[k] = v
    return out


def _attrs_from_json(attrs):
    out = {}
    for k, v in attrs.items():
        if isinstance(v, dict) and "__ndarray__" in v:
            out[k] = np.array(v["__ndarray__"], dtype=v["dtype"])
        else:
            out[k] = v
    return out


class Block:
    """Ordered op list + var map; nested via parent_idx."""

    def __init__(self, program: "Program", idx: int, parent_idx: int = -1):
        self.program = program
        self.idx = idx
        self.parent_idx = parent_idx
        self.vars: Dict[str, Variable] = {}
        self.ops: List[Operator] = []

    @property
    def parent(self) -> Optional["Block"]:
        return (self.program.blocks[self.parent_idx]
                if self.parent_idx >= 0 else None)

    def create_var(self, name=None, **kw) -> Variable:
        name = name or unique_name.generate("tmp")
        v = Variable(self, name, **kw)
        self.vars[name] = v
        self.program._bump()
        return v

    def create_parameter(self, name, shape, dtype="float32", **kw) -> Parameter:
        p = Parameter(self, name, shape, dtype=dtype, **kw)
        self.vars[name] = p
        self.program._bump()
        return p

    def var(self, name: str) -> Variable:
        """Find var here or in ancestor blocks."""
        b: Optional[Block] = self
        while b is not None:
            if name in b.vars:
                return b.vars[name]
            b = b.parent
        raise KeyError(f"Variable {name!r} not found in block {self.idx}")

    def has_var(self, name: str) -> bool:
        try:
            self.var(name)
            return True
        except KeyError:
            return False

    def append_op(self, type: str, inputs=None, outputs=None,
                  attrs=None, index: Optional[int] = None) -> Operator:
        """Append the op, or insert it before position `index`."""
        op = Operator(self, type, inputs, outputs, attrs)
        if index is None:
            self.ops.append(op)
        else:
            self.ops.insert(index, op)
        self.program._bump()
        return op

    def to_dict(self):
        return {"idx": self.idx, "parent_idx": self.parent_idx,
                "vars": [v.to_dict() for v in self.vars.values()],
                "ops": [op.to_dict() for op in self.ops]}


class Program:
    """A whole serializable program."""

    _uid_counter = itertools.count()

    def __init__(self):
        self.blocks: List[Block] = [Block(self, 0)]
        self._current_block_idx = 0
        self.random_seed: Optional[int] = None
        # bumped by every mutation through the Block API; with the
        # process-unique uid it keys the Executor's verification memo
        self._version = 0
        self._uid = next(Program._uid_counter)
        # top-level dict keys written by other tools (see _OWN_KEYS)
        self._extra: Dict[str, Any] = {}

    # -- structure ---------------------------------------------------------
    def global_block(self) -> Block:
        return self.blocks[0]

    def current_block(self) -> Block:
        return self.blocks[self._current_block_idx]

    def create_block(self, parent_idx: Optional[int] = None) -> Block:
        """A new block whose parent is `parent_idx` (the current block by
        default); it becomes the current block, where layers append."""
        parent = self._current_block_idx if parent_idx is None else parent_idx
        b = Block(self, len(self.blocks), parent)
        self.blocks.append(b)
        self._current_block_idx = b.idx
        self._bump()
        return b

    def rollback(self):
        """Make the current block's parent current again."""
        self._current_block_idx = self.current_block().parent_idx

    def _bump(self):
        self._version += 1

    # -- introspection -----------------------------------------------------
    def list_vars(self):
        for b in self.blocks:
            yield from b.vars.values()

    def all_parameters(self) -> List[Parameter]:
        return [v for v in self.list_vars() if isinstance(v, Parameter)]

    def __repr__(self):
        lines = []
        for b in self.blocks:
            lines.append(f"Block {b.idx} (parent {b.parent_idx}):")
            for op in b.ops:
                lines.append(f"  {op!r}")
        return "\n".join(lines)

    # -- transforms --------------------------------------------------------
    def clone(self, for_test: bool = False) -> "Program":
        """Deep copy; for_test flips is_test attrs (dropout/BN switch to
        inference behaviour)."""
        p = Program.from_dict(self.to_dict())
        p.random_seed = self.random_seed
        if for_test:
            for b in p.blocks:
                for op in b.ops:
                    if "is_test" in op.attrs:
                        op.attrs["is_test"] = True
        return p

    def prune(self, feed_names: Sequence[str],
              fetch_names: Sequence[str]) -> "Program":
        """Backward-slice the program to the ops needed to compute
        fetch_names from feed_names (+persistables).  This is the core of
        save_inference_model.

        A kept control-flow op (one with a ``sub_block`` attr) needs, beyond
        its own input slots, every outer var that its sub-block's ops read
        and do not write themselves (a decoder step reading the encoder's
        states, say); those count as its inputs, so their producers are
        kept too.  The JAX package's prune walks only the global block's
        slots and drops such a producer (ROADMAP queue C).  Sub-blocks are
        kept whole, with the global vars their ops touch."""
        src = self.global_block()
        needed = set(fetch_names)
        keep: List[Operator] = []
        for op in reversed(src.ops):
            if set(op.output_names()) & needed:
                keep.append(op)
                needed |= set(op.input_names())
                needed |= self._sub_block_reads(op)
        keep.reverse()

        used = set(feed_names) | set(fetch_names)
        for op in keep:
            used |= set(op.input_names()) | set(op.output_names())
        for b in self.blocks[1:]:
            for op in b.ops:
                used |= set(op.input_names()) | set(op.output_names())

        p = self.clone()
        dst = p.global_block()
        dst.ops = []
        dst.vars = {name: v for name, v in dst.vars.items() if name in used}
        for v in dst.vars.values():
            v.block = dst
        for op in keep:
            dst.append_op(op.type, copy.deepcopy(op.inputs),
                          copy.deepcopy(op.outputs),
                          copy.deepcopy(op.attrs))
        return p

    def _sub_block_reads(self, op: Operator) -> set:
        """The outer vars that `op`'s sub-block (and the blocks nested in
        it) read and do not write; empty for an op without a
        ``sub_block`` attr."""
        if "sub_block" not in op.attrs:
            return set()
        reads, written, inner_vars = set(), set(), set()
        todo = [self.blocks[int(op.attrs["sub_block"])]]
        while todo:
            b = todo.pop()
            inner_vars |= set(b.vars)
            for inner in b.ops:
                reads |= set(inner.input_names())
                written |= set(inner.output_names())
                if "sub_block" in inner.attrs:
                    todo.append(self.blocks[int(inner.attrs["sub_block"])])
        return reads - written - inner_vars

    # -- serialization (JSON, the JAX package's format) --------------------
    def to_dict(self):
        d = {"version": 1, "random_seed": self.random_seed,
             "blocks": [b.to_dict() for b in self.blocks]}
        d.update(copy.deepcopy(self._extra))
        return d

    @staticmethod
    def from_dict(d: dict) -> "Program":
        p = Program()
        p.random_seed = d.get("random_seed")
        p._extra = {k: copy.deepcopy(v) for k, v in d.items()
                    if k not in _OWN_KEYS}
        for bd in d["blocks"][1:]:
            p.blocks.append(Block(p, bd["idx"], bd["parent_idx"]))
        for bd in d["blocks"]:
            b = p.blocks[bd["idx"]]
            for vd in bd["vars"]:
                if vd.get("is_parameter"):
                    v = b.create_parameter(
                        vd["name"], vd["shape"], vd["dtype"],
                        trainable=bool(vd.get("trainable", True)))
                else:
                    v = b.create_var(vd["name"],
                                     shape=vd["shape"] or None,
                                     dtype=vd["dtype"],
                                     persistable=vd["persistable"],
                                     stop_gradient=vd["stop_gradient"],
                                     is_data=vd["is_data"],
                                     lod_level=vd.get("lod_level", 0))
                if vd.get("sharding") is not None:
                    v.sharding = tuple(vd["sharding"])
            for od in bd["ops"]:
                b.append_op(od["type"], od["inputs"], od["outputs"],
                            _attrs_from_json(od["attrs"]))
        p._current_block_idx = 0
        return p


# --- default program plumbing ---------------------------------------------
_main_program = Program()
_startup_program = Program()


def default_main_program() -> Program:
    return _main_program


def default_startup_program() -> Program:
    return _startup_program


@contextlib.contextmanager
def program_guard(main_program: Program,
                  startup_program: Optional[Program] = None):
    global _main_program, _startup_program
    prev_main, prev_startup = _main_program, _startup_program
    _main_program = main_program
    if startup_program is not None:
        _startup_program = startup_program
    try:
        yield
    finally:
        _main_program, _startup_program = prev_main, prev_startup


def reset_default_programs():
    global _main_program, _startup_program
    _main_program = Program()
    _startup_program = Program()
    unique_name.reset()
