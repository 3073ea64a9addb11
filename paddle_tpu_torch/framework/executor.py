"""Executor: runs a Program's ops against a Scope.

Counterpart of paddle_tpu/framework/executor.py (``Scope``,
``global_scope``, ``run_ops_in_env`` and ``Executor.run``).  The JAX
package traces the whole program into one jitted XLA function; here
``run`` interprets the ops eagerly, in program order.  Each op's lowering
launches its hand-written kernel for CUDA tensors and its plain torch
version for CPU tensors.

A program without an ``autodiff`` op runs under ``torch.inference_mode()``.
A training program (one ``autodiff`` op, as framework/backward.py appends
it) is expanded as the JAX package does with ``jax.vjp``
(paddle_tpu/framework/executor.py:1162-1182): the trainable params become
leaf tensors that require grad, the ops before ``autodiff`` run under
``torch.enable_grad()``, ``torch.autograd.grad`` gives every
``param@GRAD`` (zeros for a param the loss does not reach, as JAX's vjp
gives), and the ops after it (the optimizer updates) run under
``torch.no_grad()``.  Inference tensors cannot be saved for backward, so a
training run first copies any persistable that an inference-mode run
(the startup program, say) left in the scope.

There is no compiled-program cache, mesh, ``run_steps`` or pipeline yet.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from ..core import flags
from ..core.dtypes import to_torch_dtype
from ..core.enforce import EnforceNotMet, check_arg
from ..core.place import Place, default_place
from .program import Program, Variable, default_main_program
from .registry import LowerContext, _fold, get_op_def

# Ops that are pure bookkeeping at the program level.
_STRUCTURAL_OPS = ("feed", "fetch", "data")


class Scope:
    """name -> tensor store for persistable vars (ref scope.h).
    Hierarchical: child scopes see parent vars."""

    def __init__(self, parent: Optional["Scope"] = None):
        self._vars: Dict[str, Any] = {}
        self.parent = parent

    def find_var(self, name: str):
        s: Optional[Scope] = self
        while s is not None:
            if name in s._vars:
                return s._vars[name]
            s = s.parent
        return None

    def set_var(self, name: str, value):
        self._vars[name] = value


_global_scope = Scope()


def global_scope() -> Scope:
    return _global_scope


def as_tensor(value, var: Optional[Variable], device: torch.device
              ) -> torch.Tensor:
    """A feed value (numpy array, list or tensor) as a tensor on `device`
    in the program var's declared dtype."""
    t = value if isinstance(value, torch.Tensor) else torch.as_tensor(
        np.asarray(value))
    dtype = to_torch_dtype(var.dtype) if var is not None else t.dtype
    return t.to(device=device, dtype=dtype)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A fetched tensor as a host numpy array (bf16, which numpy lacks,
    widens to f32).

    A CUDA tensor is copied into a fresh pinned host tensor on its
    stream (a DMA at the link's rate, where a pageable copy stages
    through a bounce buffer), and the array is a view of that tensor,
    which the array keeps alive: the next run never writes into a buffer
    a caller still holds, and the caching host allocator reuses the
    block once the array is gone."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    if t.device.type != "cuda":
        return t.cpu().numpy()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    torch.cuda.current_stream(t.device).synchronize()
    return host.numpy()


def run_ops_in_env(ctx: LowerContext, env: Dict[str, Any], ops
                   ) -> Dict[str, Any]:
    """Shared lowering loop: run `ops` against env, writing outputs back."""
    for op in ops:
        if op.type in _STRUCTURAL_OPS:
            continue
        opdef = get_op_def(op.type)
        ins = {}
        for slot, names in op.inputs.items():
            vals = []
            for n in names:
                if n not in env:
                    raise EnforceNotMet(
                        f"op {op.type!r} input {slot}:{n!r} is not "
                        f"materialised; feed it or run its producer")
                vals.append(env[n])
            ins[slot] = vals
        outs = opdef.lower(ctx, ins, op.attrs)
        for slot, names in op.outputs.items():
            for n, v in zip(names, outs.get(slot, [])):
                if n:
                    env[n] = v
    return env


class Executor:
    """User-facing executor.

    exe = Executor(CUDAPlace(0))      # Executor() means the same
    exe.run(startup_program)
    loss, = exe.run(main_program, feed={...}, fetch_list=[loss_var])
    """

    def __init__(self, place: Optional[Place] = None,
                 scope: Optional[Scope] = None):
        self.place = place or default_place()
        self.scope = scope or global_scope()
        self._run_counter = 0

    def _seed(self, program: Program) -> int:
        """The program's seed; an unseeded program folds the run counter
        into the global seed so successive runs draw anew."""
        counter = self._run_counter
        self._run_counter += 1
        if program.random_seed is not None:
            return int(program.random_seed)
        return _fold(flags.get_flag("rng_seed"), counter)

    def run(self, program: Optional[Program] = None,
            feed: Optional[Dict[str, Any]] = None,
            fetch_list: Optional[Sequence] = None,
            scope: Optional[Scope] = None,
            return_numpy: bool = True):
        program = program or default_main_program()
        scope = scope or self.scope
        device = self.place.torch_device()
        block = program.global_block()
        fetch_names = [f.name if isinstance(f, Variable) else str(f)
                       for f in (fetch_list or [])]
        ops = [op for op in block.ops if op.type not in _STRUCTURAL_OPS]
        persist = sorted({v.name for v in program.list_vars()
                          if v.persistable})
        ctx = LowerContext(self._seed(program), device)
        ad_idx = [i for i, op in enumerate(ops) if op.type == "autodiff"]
        check_arg(len(ad_idx) <= 1,
                  "at most one autodiff op per program is supported")
        if ad_idx:
            env = self._run_training(ctx, scope, block, ops, ad_idx[0],
                                     persist, feed, device)
        else:
            with torch.inference_mode():
                env = self._load_env(scope, block, persist, feed, device)
                env = run_ops_in_env(ctx, env, ops)
        written = {n for op in ops for n in op.output_names()}
        for n in persist:
            if n in written:
                scope.set_var(n, env[n])
        missing = [n for n in fetch_names if n not in env]
        if missing:
            raise KeyError(f"fetch targets {missing} are neither fed, "
                           f"persistable nor produced by the program")
        fetches = [env[n].detach() for n in fetch_names]
        if return_numpy:
            return [to_numpy(t) for t in fetches]
        return fetches

    @staticmethod
    def _load_env(scope, block, persist, feed, device) -> Dict[str, Any]:
        env: Dict[str, Any] = {}
        for n in persist:
            val = scope.find_var(n)
            if val is not None:
                env[n] = val.to(device)
        for name, val in (feed or {}).items():
            var = block.var(name) if block.has_var(name) else None
            env[name] = as_tensor(val, var, device)
        return env

    def _run_training(self, ctx, scope, block, ops, ad_idx, persist, feed,
                      device) -> Dict[str, Any]:
        """Forward under autograd, ``torch.autograd.grad`` at the
        ``autodiff`` op, then the update ops without autograd."""
        attrs = ops[ad_idx].attrs
        loss_name = attrs["loss"]
        env = self._load_env(scope, block, persist, feed, device)
        for n, t in env.items():
            if t.is_inference():
                env[n] = t.clone()
        params = []
        for n in attrs["params"]:
            if n not in env:
                raise EnforceNotMet(f"autodiff: parameter {n!r} is not in "
                                    f"the scope; run the startup program")
            env[n] = env[n].detach().requires_grad_(True)
            params.append(env[n])
        with torch.enable_grad():
            env = run_ops_in_env(ctx, env, ops[:ad_idx])
            loss = env[loss_name]
            check_arg(loss.numel() == 1,
                      f"autodiff loss {loss_name!r} must be scalar, got "
                      f"shape {tuple(loss.shape)}")
            grads = torch.autograd.grad(loss, params,
                                        torch.ones_like(loss),
                                        allow_unused=True)
        for n, p in zip(attrs["params"], params):
            env[n] = p.detach()
        for gname, p, g in zip(attrs["grads"], params, grads):
            env[gname] = torch.zeros_like(p) if g is None else g
        with torch.no_grad():
            env = run_ops_in_env(ctx, env, ops[ad_idx + 1:])
        return env
