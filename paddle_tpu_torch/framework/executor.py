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
(the startup program, say) left in the scope.  A persistable the run
wrote is stored into the scope only if it carries no autograd state (no
``requires_grad``, no ``grad_fn``); otherwise ``run`` raises
EnforceNotMet: such a tensor would keep the step's graph alive.

``run_steps`` (JAX :1405-1486) runs N training steps: the JAX package
scans its compiled step on the device; here it is a host loop of eager
steps over feeds uploaded once, with one readback at the end.  Under
``FLAGS_check_nan_inf`` every fetch is scanned for NaN/Inf, and under
``FLAGS_check_nan_inf_per_op`` every op's outputs (the ``autodiff`` op's
are the grads), naming the first op that made one.

Before a program runs, ``run`` and ``run_steps`` verify it
(paddle_tpu_torch/analysis) under ``FLAGS_verify_program``, as the JAX
Executor does before it compiles (JAX :1488-1530): ``error`` rejects a
program with a ProgramVerificationError before any op runs, any kernel
launches or any feed is uploaded; ``warn`` (the default) runs the O(ops)
lints and warns once per (program, fetch list); ``off`` skips it.  There
is no compile cache to hang the verdict on, so the Executor keeps it per
key (program uid and version, feed names and shapes, fetch names,
``donate_feeds``): a key is verified once, not every step.

There is no compiled-program cache, mesh or pipeline yet.
"""
from __future__ import annotations

import warnings
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
    """A fetched tensor as a host numpy array (bf16 and fp8, which numpy
    lacks, widen to f32).

    A CUDA tensor is copied into a fresh pinned host tensor on its
    stream (a DMA at the link's rate, where a pageable copy stages
    through a bounce buffer), and the array is a view of that tensor,
    which the array keeps alive: the next run never writes into a buffer
    a caller still holds, and the caching host allocator reuses the
    block once the array is gone."""
    t = t.detach()
    if t.dtype in (torch.bfloat16, torch.float8_e4m3fn, torch.float8_e5m2):
        t = t.float()
    if t.device.type != "cuda":
        return t.cpu().numpy()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    torch.cuda.current_stream(t.device).synchronize()
    return host.numpy()


def _check_op_outputs_finite(op, outs):
    """Per-op NaN/Inf localization (ref operator.cc:829), under
    FLAGS_check_nan_inf_per_op; meta tensors (shape inference) are
    skipped."""
    for slot, vals in outs.items():
        for name, v in zip(op.outputs.get(slot, []), vals):
            if (isinstance(v, torch.Tensor) and v.is_floating_point()
                    and v.device.type != "meta"
                    and not bool(torch.isfinite(v).all())):
                raise EnforceNotMet(
                    f"NaN/Inf produced by op {op.type!r} in output "
                    f"{slot}:{name!r} (FLAGS_check_nan_inf_per_op)")


def _check_detached(name, t, ops):
    """A persistable the run wrote must not carry autograd state into the
    scope: a tensor with a grad_fn would keep the whole step's saved
    activations alive and chain the next step onto them (a forward op's
    state output, such as batch_norm's MeanOut, detaches itself, as JAX
    stop_gradients it)."""
    if isinstance(t, torch.Tensor) and (t.requires_grad
                                        or t.grad_fn is not None):
        writers = [op.type for op in ops if name in op.output_names()]
        raise EnforceNotMet(
            f"persistable {name!r} (written by {writers}) requires grad or "
            f"carries a grad_fn: an op wrote autograd state into the scope; "
            f"its lowering must detach the state it writes")


def run_ops_in_env(ctx: LowerContext, env: Dict[str, Any], ops
                   ) -> Dict[str, Any]:
    """Shared lowering loop: run `ops` against env, writing outputs back.
    Control-flow ops (ops/control_flow.py) recurse into it for their
    sub-blocks; ``ctx.env`` is the innermost live env while an op lowers
    and is restored after it."""
    per_op = flags.get_flag("check_nan_inf_per_op")
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
        prev_env, ctx.env = ctx.env, env
        try:
            outs = opdef.lower(ctx, ins, op.attrs)
        finally:
            ctx.env = prev_env
        for slot, names in op.outputs.items():
            for n, v in zip(names, outs.get(slot, [])):
                if n:
                    env[n] = v
        if per_op:
            _check_op_outputs_finite(op, outs)
    return env


def feed_shape(v) -> tuple:
    """A feed's shape, read from its ``.shape`` where it has one (a device
    tensor is not copied to the host to find it)."""
    return tuple(v.shape) if hasattr(v, "shape") else np.shape(v)


def fetch_names(fetch_list) -> list:
    """The names of a fetch list of Variables or names."""
    return [f.name if isinstance(f, Variable) else str(f)
            for f in (fetch_list or [])]


def check_slabs(feed: Dict[str, Any], seq, steps: int):
    """run_steps' feed contract: every per-step feed is fed, with a
    leading dim of `steps`, read from its ``.shape`` (a device tensor is
    not copied to the host to find it)."""
    missing = set(seq) - set(feed)
    check_arg(not missing, f"per_step_feeds {sorted(missing)} not in feed")
    for name in seq:
        shape = feed_shape(feed[name])
        n0 = shape[0] if len(shape) else None
        check_arg(n0 == steps, f"per-step feed {name!r} leading dim {n0} "
                               f"!= steps {steps}")


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
        # the verification memo: key -> its AnalysisResult
        self._verified: Dict[tuple, Any] = {}
        # (program uid, fetch names) already warned about in warn mode
        self._verify_warned: set = set()

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
            return_numpy: bool = True,
            donate_feeds: bool = False):
        """Run `program` once.  ``donate_feeds`` is the reference's
        signature: the JAX package donates the feed buffers to the step;
        here it means only what is true of every run, that the executor
        keeps no reference to the feeds after the call."""
        program = program or default_main_program()
        scope = scope or self.scope
        fetched = fetch_names(fetch_list)
        self._verify_before_run(program, feed, fetched, scope, donate_feeds)
        device = self.place.torch_device()
        block = program.global_block()
        ops = [op for op in block.ops if op.type not in _STRUCTURAL_OPS]
        persist = sorted({v.name for v in program.list_vars()
                          if v.persistable})
        ctx = LowerContext(self._seed(program), device, program)
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
        stored = [n for n in persist if n in written]
        for n in stored:        # all checked before the scope takes any
            _check_detached(n, env[n], ops)
        for n in stored:
            scope.set_var(n, env[n])
        missing = [n for n in fetched if n not in env]
        if missing:
            raise KeyError(f"fetch targets {missing} are neither fed, "
                           f"persistable nor produced by the program")
        fetches = [env[n].detach() for n in fetched]
        if flags.get_flag("check_nan_inf"):
            for n, t in zip(fetched, fetches):
                if t.is_floating_point() and not bool(
                        torch.isfinite(t).all()):
                    raise EnforceNotMet(f"NaN/Inf detected in fetch {n!r}")
        if return_numpy:
            return [to_numpy(t) for t in fetches]
        return fetches

    def run_steps(self, program: Optional[Program] = None,
                  feed: Optional[Dict[str, Any]] = None,
                  fetch_list: Optional[Sequence] = None,
                  steps: int = 1,
                  per_step_feeds: Sequence[str] = (),
                  scope: Optional[Scope] = None,
                  return_numpy: bool = True):
        """Run `steps` training iterations in one call.

        Feeds named in `per_step_feeds` must carry a leading [steps]
        dimension and are sliced one slab per iteration; all other feeds
        are repeated every iteration.  Fetches come back stacked with a
        leading [steps] axis.  State advances exactly as `steps`
        sequential run() calls would, each step's RNG seed included (each
        step is one run(), which folds the run counter), and is written
        back to the scope.

        Each feed is uploaded once and a step's slab is a slice of it on
        the device; nothing is read back between steps, and the fetches
        are stacked into new tensors, read back once at the end.  Under
        the NaN/Inf flags each step's run() scans as it does alone.
        """
        program = program or default_main_program()
        check_arg(steps >= 1, f"steps must be >= 1, got {steps}")
        seq = frozenset(per_step_feeds)
        feed = feed or {}
        check_slabs(feed, seq, steps)
        # the key each step's run() takes: the slabs' shapes less [steps]
        self._verify_before_run(program, feed, fetch_names(fetch_list),
                                scope or self.scope, False, seq_names=seq)
        device = self.place.torch_device()
        block = program.global_block()
        dev = {k: as_tensor(v, block.var(k) if block.has_var(k) else None,
                            device) for k, v in feed.items()}
        outs = [self.run(program, {k: (v[i] if k in seq else v)
                                   for k, v in dev.items()},
                         fetch_list, scope, return_numpy=False)
                for i in range(steps)]
        stacked = [torch.stack([o[j] for o in outs])
                   for j in range(len(outs[0]))]
        if return_numpy:
            return [to_numpy(t) for t in stacked]
        return stacked

    def _verify_before_run(self, program, feed, fetched, scope,
                           donate_feeds, seq_names=()):
        """Static verification under FLAGS_verify_program, once per key,
        before anything of the run happens (JAX executor.py:1488-1530).
        'error' runs the whole verifier (shape inference on meta tensors
        included) and raises on error findings; 'warn' runs the O(ops)
        lints and warns once per (program, fetch list); 'off' returns."""
        mode = str(flags.get_flag("verify_program"))
        if mode not in ("warn", "error"):
            return
        # run_steps' per-step slabs carry a leading [steps] dim that no op
        # sees: each step's run() gets a slice of it
        feed_shapes = {n: (feed_shape(v)[1:] if n in seq_names
                           else feed_shape(v))
                       for n, v in (feed or {}).items()}
        key = (mode, program._uid, program._version,
               tuple(sorted(feed_shapes.items())), tuple(fetched),
               bool(donate_feeds))
        result = self._verified.get(key)
        if result is None:
            from .. import analysis
            check = (analysis.verify_program if mode == "error"
                     else analysis.quick_lints)
            kw = dict(feed_shapes=feed_shapes) if mode == "error" else {}
            result = self._verified[key] = check(
                program, feed=set(feed_shapes), fetch_list=fetched,
                scope=scope, donate_feeds=donate_feeds, **kw)
        errs = result.errors
        if not errs:
            return
        if mode == "error":
            from .. import analysis
            raise analysis.ProgramVerificationError(
                f"program v{program._version} failed verification "
                f"(verify_program=error); nothing ran.  Findings:\n"
                + result.report(), result)
        wkey = (program._uid, tuple(fetched))
        if wkey not in self._verify_warned:
            self._verify_warned.add(wkey)
            warnings.warn(
                f"program verification found {len(errs)} error(s) "
                f"(verify_program=warn; the run proceeds):\n"
                + result.report(max_findings=10),
                RuntimeWarning, stacklevel=3)

    def close(self):
        """The reference's API: its executor drops its compiled programs
        here.  This one keeps none, so there is nothing to release."""

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
        if flags.get_flag("check_nan_inf_per_op"):
            _check_op_outputs_finite(
                ops[ad_idx], {"Grads": [env[g] for g in attrs["grads"]]})
        with torch.no_grad():
            env = run_ops_in_env(ctx, env, ops[ad_idx + 1:])
        return env
