"""Program-IR traversal helpers shared by every analysis pass
(counterpart of paddle_tpu/analysis/traversal.py)."""
from __future__ import annotations

from typing import Iterator, List, Tuple

from ..framework.program import Block, Operator, Program

# Ops the executor interprets structurally (no dataflow of their own).
STRUCTURAL_OPS = ("feed", "fetch", "data")


def iter_ops(program: Program) -> Iterator[Tuple[Block, int, Operator]]:
    """Yield (block, op_index, op) over every block in program order.
    ``op_index`` is the position in ``block.ops`` INCLUDING structural
    ops."""
    for block in program.blocks:
        for i, op in enumerate(block.ops):
            yield block, i, op


def op_input_names(op: Operator) -> List[str]:
    return [n for ns in op.inputs.values() for n in ns if n]


def op_output_names(op: Operator) -> List[str]:
    return [n for ns in op.outputs.values() for n in ns if n]


def declared_info(block: Block, name: str):
    """(shape tuple | None, dtype str | None) of a var as DECLARED in
    the program, walking ancestor blocks; (None, None) when unknown."""
    if not block.has_var(name):
        return None, None
    v = block.var(name)
    shape = tuple(int(s) for s in v.shape) if v.shape else None
    return shape, (str(v.dtype) if v.dtype else None)
