"""Save/load of variables and inference models.

Counterpart of paddle_tpu/io.py, in its on-disk format: ``__model__`` is
the JSON of {program, feed_names, fetch_names}; parameters go to one
``__params__.npz`` plus a ``.dtypes`` JSON sidecar, with bf16 stored as f32
(npz has no bf16).  A model dir saved by paddle_tpu therefore loads here
unchanged, and the other way round: this is the seam that carries weights
across the two packages.  ``params_from_numpy`` binds weights held in
memory.

fp8 (a frozen fp8 program's weights) goes to the npz as its uint8 bytes,
the dtype's name in ``.dtypes``.  The JAX package writes an ml_dtypes fp8
array, which np.savez stores as raw ``<V1`` bytes under the same name (and
which its own load_vars cannot read back, ROADMAP C); load_vars here reads
both by that name.  No module of the port imports ml_dtypes: an fp8 array
handed to params_from_numpy is recognised by its dtype's name.
"""
from __future__ import annotations

import ast
import json
import math
import os
import struct
import zipfile
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from .core.dtypes import FP8_NAMES, convert_dtype, to_torch_dtype
from .core.enforce import check_arg
from .core.place import Place
from .framework.executor import Executor, Scope, to_numpy
from .framework.program import Program, Variable, default_main_program

MODEL_FILENAME = "__model__"
PARAMS_FILENAME = "__params__.npz"


def save_vars(executor: Executor, dirname: str, var_names: Sequence[str],
              scope: Optional[Scope] = None,
              filename: str = PARAMS_FILENAME):
    scope = scope or executor.scope
    os.makedirs(dirname, exist_ok=True)
    arrays, dtypes = {}, {}
    for name in var_names:
        val = scope.find_var(name)
        check_arg(val is not None, f"var {name!r} not found in scope")
        dt = convert_dtype(val.dtype)
        # bf16 widens to f32 and fp8 goes as its bytes; the name marks both
        arrays[name] = to_numpy(val.view(torch.uint8) if dt in FP8_NAMES
                                else val)
        dtypes[name] = dt
    # write through a file object so np.savez cannot append '.npz' to a
    # custom filename and break the load path
    with open(os.path.join(dirname, filename), "wb") as f:
        np.savez(f, **arrays)
    with open(os.path.join(dirname, filename + ".dtypes"), "w") as f:
        json.dump(dtypes, f)


def save_persistables(executor: Executor, dirname: str,
                      main_program: Optional[Program] = None,
                      filename: str = PARAMS_FILENAME):
    program = main_program or default_main_program()
    names = [v.name for v in program.list_vars() if v.persistable]
    names = [n for n in names if executor.scope.find_var(n) is not None]
    save_vars(executor, dirname, names, filename=filename)


def _fp8_member(path: str, name: str) -> np.ndarray:
    """One fp8 member of an npz as a uint8 array of its bytes, read from
    the .npy header and payload directly: np.load cannot parse the descr
    ml_dtypes' arrays are saved under ('<V1' or '<f1') without ml_dtypes'
    types registered."""
    with zipfile.ZipFile(path) as zf, zf.open(name + ".npy") as f:
        major, _ = np.lib.format.read_magic(f)
        size = struct.unpack("<H" if major == 1 else "<I",
                             f.read(2 if major == 1 else 4))[0]
        header = ast.literal_eval(f.read(size).decode("latin1"))
        shape = tuple(header["shape"])
        check_arg(str(header["descr"]).endswith("1"),
                  f"{name!r}: an fp8 payload of descr {header['descr']!r}")
        raw = np.frombuffer(f.read(), dtype=np.uint8)[:math.prod(shape)]
    return raw.reshape(shape, order="F" if header["fortran_order"] else "C")


def _from_bytes(arr: np.ndarray, name: str) -> torch.Tensor:
    """An fp8 tensor from a host array of its bytes (uint8, ml_dtypes' fp8,
    or np.savez's raw ``<V1``)."""
    raw = np.ascontiguousarray(arr).view(np.uint8)
    return torch.from_numpy(raw.copy()).view(to_torch_dtype(name))


def params_from_numpy(scope: Scope, arrays: Dict[str, np.ndarray],
                      place: Place):
    """Bind host arrays to scope vars on `place`, keeping each array's
    dtype (a 'bfloat16' array from ml_dtypes becomes a torch bf16, an
    ml_dtypes fp8 one the torch fp8 of its name)."""
    device = place.torch_device()
    for name, arr in arrays.items():
        arr = np.asarray(arr)
        dt = convert_dtype(arr.dtype)
        if dt == "bfloat16":
            t = torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
        elif dt in FP8_NAMES:
            t = _from_bytes(arr, dt)
        else:
            t = torch.from_numpy(np.array(arr))   # owned, writable copy
        scope.set_var(name, t.to(device))


def load_vars(executor: Executor, dirname: str,
              var_names: Optional[Sequence[str]] = None,
              scope: Optional[Scope] = None,
              filename: str = PARAMS_FILENAME):
    scope = scope or executor.scope
    path = os.path.join(dirname, filename)
    dtypes = {}
    dt_path = path + ".dtypes"
    if os.path.exists(dt_path):
        with open(dt_path) as f:
            dtypes = json.load(f)
    device = executor.place.torch_device()
    with np.load(path) as data:
        names = var_names if var_names is not None else list(data.files)
        for name in names:
            check_arg(name in data.files, f"{name!r} missing in checkpoint")
            if dtypes.get(name) in FP8_NAMES:
                t = _from_bytes(_fp8_member(path, name), dtypes[name])
            else:
                t = torch.from_numpy(data[name])
                if name in dtypes:
                    t = t.to(to_torch_dtype(dtypes[name]))
            scope.set_var(name, t.to(device))


def load_persistables(executor: Executor, dirname: str,
                      main_program: Optional[Program] = None,
                      filename: str = PARAMS_FILENAME):
    """Every persistable var of the program from `dirname` (what
    save_persistables wrote, in either package) into the executor's
    scope on its place."""
    program = main_program or default_main_program()
    names = [v.name for v in program.list_vars() if v.persistable]
    load_vars(executor, dirname, names, filename=filename)


def save_inference_model(dirname: str, feeded_var_names: Sequence[str],
                         target_vars: Sequence[Variable],
                         executor: Executor,
                         main_program: Optional[Program] = None,
                         model_filename: str = MODEL_FILENAME,
                         params_filename: str = PARAMS_FILENAME):
    """Prune program to the inference slice + save params."""
    program = main_program or default_main_program()
    program = program.clone(for_test=True)
    fetch_names = [v.name if isinstance(v, Variable) else str(v)
                   for v in target_vars]
    pruned = program.prune(feeded_var_names, fetch_names)
    os.makedirs(dirname, exist_ok=True)
    meta = {"program": pruned.to_dict(),
            "feed_names": list(feeded_var_names),
            "fetch_names": fetch_names}
    with open(os.path.join(dirname, model_filename), "w") as f:
        json.dump(meta, f)
    persist = [v.name for v in pruned.list_vars() if v.persistable]
    persist = [n for n in persist if executor.scope.find_var(n) is not None]
    save_vars(executor, dirname, persist, filename=params_filename)
    return fetch_names


def load_inference_model(dirname: str, executor: Executor,
                         model_filename: str = MODEL_FILENAME,
                         params_filename: str = PARAMS_FILENAME):
    """Returns (program, feed_names, fetch_names); the params land in
    executor.scope on executor.place."""
    with open(os.path.join(dirname, model_filename)) as f:
        meta = json.load(f)
    program = Program.from_dict(meta["program"])
    names = [v.name for v in program.list_vars() if v.persistable]
    if names:
        load_vars(executor, dirname, names, filename=params_filename)
    return program, meta["feed_names"], meta["fetch_names"]
