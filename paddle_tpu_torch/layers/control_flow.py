"""Control-flow layers (counterpart of paddle_tpu/layers/control_flow.py:
While :22, Switch :58 with ``_conditional_block`` :100, StaticRNN :115).

The block-builder API of the reference: a context manager appends ops
into a sub-block, and one op in the parent block runs it
(ops/control_flow.py): ``while`` for a ``While``, a chain of
``conditional_block`` ops for a ``Switch``, ``static_rnn_scan`` for a
``StaticRNN``.  The ops, their order and their var names are the JAX
package's, so both builds serialize alike.
"""
from __future__ import annotations

import contextlib
from typing import List, Optional

from ..framework import unique_name
from ..framework.layer_helper import LayerHelper
from ..framework.program import Variable
from ..ops.control_flow import _block_written_vars


@contextlib.contextmanager
def _sub_block(program):
    """A new sub-block of the current block, current inside the `with`;
    yields (sub-block, parent block)."""
    parent_idx = program._current_block_idx
    sub = program.create_block()
    try:
        yield sub, program.blocks[parent_idx]
    finally:
        program._current_block_idx = parent_idx


def _outer_writes(sub, parent) -> List[str]:
    """The vars `sub` writes that exist outside it: the state the op
    carries out of its sub-block."""
    return [n for n in _block_written_vars(sub) if parent.has_var(n)]


class While:
    """A loop over a sub-block while `cond` holds.

    i = layers.fill_constant([1], "int64", 0)
    n = layers.fill_constant([1], "int64", 10)
    cond = layers.less_than(i, n)
    w = layers.While(cond)
    with w.block():
        ...                                # ops writing the loop state
        layers.less_than(i, n, cond=cond)  # the condition, rewritten

    The ``while`` op carries every var the block writes that exists
    outside it, and the condition; each keeps its dtype and shape."""

    def __init__(self, cond: Variable, name=None):
        self.helper = LayerHelper("while", name=name)
        self.cond_var = cond
        self.program = self.helper.main_program

    @contextlib.contextmanager
    def block(self):
        with _sub_block(self.program) as (sub, parent):
            yield
        outs = _outer_writes(sub, parent)
        if self.cond_var.name not in outs:
            outs.append(self.cond_var.name)
        parent.append_op("while", {"Cond": [self.cond_var.name]},
                         {"Out": outs},
                         {"sub_block": sub.idx,
                          "condition": self.cond_var.name,
                          "out_vars": outs})


class Switch:
    """A chain of conditional blocks, the first case that holds taken.

    with layers.Switch() as switch:
        with switch.case(cond1): ...assign...
        with switch.default(): ...assign...

    A case's condition is ANDed with the negation of every earlier case's
    and ``default`` takes the negation of them all."""

    def __init__(self, name=None):
        self.helper = LayerHelper("switch", name=name)
        self.program = self.helper.main_program
        self._case_conds: List[Variable] = []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    @contextlib.contextmanager
    def case(self, condition: Variable):
        from . import nn
        cond = condition
        for prev in self._case_conds:
            cond = nn.logical_and(cond, nn.logical_not(prev))
        self._case_conds.append(condition)
        with _conditional_block(self.program, cond):
            yield

    @contextlib.contextmanager
    def default(self):
        from . import nn
        assert self._case_conds, "default() requires at least one case()"
        cond = nn.logical_not(self._case_conds[0])
        for prev in self._case_conds[1:]:
            cond = nn.logical_and(cond, nn.logical_not(prev))
        with _conditional_block(self.program, cond):
            yield


@contextlib.contextmanager
def _conditional_block(program, cond: Variable):
    """A ``conditional_block`` op over the ops built inside the `with`;
    its out_vars are the vars they write that exist outside."""
    with _sub_block(program) as (sub, parent):
        yield
    outs = _outer_writes(sub, parent)
    parent.append_op("conditional_block", {"Cond": [cond.name]},
                     {"Out": outs}, {"sub_block": sub.idx, "out_vars": outs})


class StaticRNN:
    """A per-step block over [B, T, ...] inputs, run as one
    ``static_rnn_scan`` op.

    rnn = layers.StaticRNN()
    with rnn.step():
        x_t = rnn.step_input(x)            # [B, D], a step of [B, T, D]
        h_prev = rnn.memory(init=h0)       # the carried state
        h = layers.fc(layers.concat([x_t, h_prev], 1), size=H, act="tanh")
        rnn.update_memory(h_prev, h)
        rnn.step_output(h)
    out = rnn()                            # [B, T, H]

    A memory keeps its dtype and shape from step to step: the op raises
    where one changes (lax.scan's rule in the JAX package).
    """

    def __init__(self, name=None):
        self.helper = LayerHelper("static_rnn", name=name)
        self.program = self.helper.main_program
        self._x: List[tuple] = []          # (outer var, inner var)
        self._memories: List[dict] = []
        self._outputs: List[Variable] = []
        self._sub = None
        self._parent_idx = None
        self._result: Optional[List[Variable]] = None

    @contextlib.contextmanager
    def step(self):
        with _sub_block(self.program) as (self._sub, parent):
            self._parent_idx = parent.idx
            yield
        self._finalize()

    def step_input(self, x: Variable) -> Variable:
        """x: an outer [B, T, ...] var; returns the step's [B, ...] var."""
        inner = self._sub.create_var(
            name=unique_name.generate("rnn_step_in"), dtype=x.dtype,
            shape=(x.shape[0],) + tuple(x.shape[2:]) if x.shape else None)
        self._x.append((x, inner))
        return inner

    def memory(self, init: Variable) -> Variable:
        """A state carried across steps, starting from `init`."""
        inner = self._sub.create_var(
            name=unique_name.generate("rnn_mem"), dtype=init.dtype,
            shape=init.shape)
        self._memories.append({"init": init, "pre": inner, "new": None})
        return inner

    def update_memory(self, mem: Variable, new: Variable):
        for m in self._memories:
            if m["pre"].name == mem.name:
                m["new"] = new
                return
        raise ValueError(f"{mem.name} is not a memory of this StaticRNN")

    def step_output(self, out: Variable):
        self._outputs.append(out)

    def _finalize(self):
        parent = self.program.blocks[self._parent_idx]
        for m in self._memories:
            if m["new"] is None:
                raise ValueError("every memory needs update_memory()")
        # the step ends by binding each memory's name to its new value;
        # the op reads the carries under those names
        for m in self._memories:
            self._sub.append_op("assign", {"X": [m["new"].name]},
                                {"Out": [m["pre"].name]}, {})
        carry = [m["pre"].name for m in self._memories]
        # the op scans dim 0, so each [B, T, ...] input is transposed to
        # [T, B, ...] in the parent block first
        x_names = []
        for outer, inner in self._x:
            perm = list(range(len(outer.shape)))
            perm[0], perm[1] = 1, 0
            t_var = parent.create_var(
                name=unique_name.generate(outer.name + ".tbd"),
                dtype=outer.dtype)
            parent.append_op("transpose", {"X": [outer.name]},
                             {"Out": [t_var.name]}, {"axis": perm})
            x_names.append((t_var.name, inner.name))
        y_names = [o.name for o in self._outputs]

        # the outputs stack the steps as [T, ...]; T is the first input's
        # time dim where it is static
        T = None
        if self._x:
            outer0 = self._x[0][0]
            if outer0.shape and len(outer0.shape) > 1:
                T = outer0.shape[1]
        outs = []
        for o in self._outputs:
            shape = ((T,) + tuple(o.shape)) if (T is not None and
                                                o.shape is not None) else None
            outs.append(parent.create_var(
                name=unique_name.generate("rnn_out"), dtype=o.dtype,
                shape=shape))
        carry_outs = [parent.create_var(
            name=unique_name.generate("rnn_carry"), dtype=m["init"].dtype,
            shape=m["init"].shape)
            for m in self._memories]
        parent.append_op(
            "static_rnn_scan",
            {"Init": [m["init"].name for m in self._memories],
             "X": [t for t, _ in x_names]},
            {"Ys": [o.name for o in outs],
             "CarryOut": [c.name for c in carry_outs]},
            {"sub_block": self._sub.idx,
             "carry_vars": carry,
             "x_inner_vars": [i for _, i in x_names],
             "y_vars": y_names})
        self._result = outs

    def __call__(self) -> Variable:
        """The first step_output, stacked over time as [B, T, ...]."""
        helper = LayerHelper("static_rnn_out")
        out = self._result[0]
        tr = helper.create_variable_for_type_inference(out.dtype)
        nd = len(self._outputs[0].shape or (0, 0)) + 1
        perm = list(range(nd))
        perm[0], perm[1] = 1, 0
        if out.shape is not None and len(out.shape) >= 2:
            tr.shape = (out.shape[1], out.shape[0]) + tuple(out.shape[2:])
        helper.main_program.current_block().append_op(
            "transpose", {"X": [out.name]}, {"Out": [tr.name]},
            {"axis": perm})
        return tr

    def outputs(self) -> List[Variable]:
        """Every step_output, stacked over time as [T, B, ...]."""
        return self._result
