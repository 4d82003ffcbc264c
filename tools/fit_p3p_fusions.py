"""Read the compiled reference P3P's fusions off XLA's optimised HLO, with
LLVM's contractions, and check them stage by stage.

Runs with the JAX package on the CPU, on the host type whose rounding the
port copies (tod_tpu_torch/geometry/pnp.py and kernel P1, csrc/p3p.cu):

    JAX_PLATFORMS=cpu python tools/fit_p3p_fusions.py [--samples 20000]
        [--list] [--no-2d]

XLA:CPU hands each fusion to LLVM, which rewrites it before the backend
contracts multiply-adds. The interpreter here evaluates the optimised HLO
(``--xla_dump_to``) in numpy and models, inside every fusion (each rule
read off a fusion's ``*.ir-with-opt.ll`` where ``--oracle`` showed the
model wrong):

- InstCombine's negations: ``X * -C`` is ``-(X * C)`` and the sign moves
  out of products and quotients; a negated value (``fneg``) stays one
  inside a product; ``(-A) + B`` is ``B - A``, ``A + (-B)`` is ``A - B``,
  ``A - (-B)`` is ``A + B``;
- InstCombine's ``select(c, x - z, y - z)`` -> ``select(c, x, y) - z``
  (Ferrari's ``- A / 3`` leaves both branches of the resolvent's root);
- a concatenate's operands as regions of their own (no value shared), as
  XLA emits the four roots (not the first distances', which the loop
  vectoriser interleaves: not modelled);
- XLA's ``rsqrt``: the host's ``rsqrtps`` (a table by the exponent's
  parity and the mantissa's top 10 bits, read by compiling a few lines of
  C here) and two Newton steps, contracted;
- Reassociate's operand order for commutative adds (the lower rank left:
  loads and calls ranked in the order the emitter reaches them, an
  expression one above its operands, constants right), then CSE;
- the backend's contraction: a product with one use folds into the add or
  subtract that takes it (the left operand first), a product by 2 becomes
  ``x + x`` and folds into nothing, a reduce's add chain takes its
  products.

The lapack custom calls run ``tools/fit_lapack_order.py``'s reading. It
prints each fusion of interest as its contracted expression (``--list``
prints every fusion's) and checks:

1. the four fusions of the normalised quartic coefficients ``C3/C4 ..
   C0/C4`` against the compiled reference's (``fit_p3p_order.py``'s
   jitted stages) and the port's ``pnp.quartic_normalized``, bit for bit;
2. whether the 2D path's programs (the jitted ``detect_frame_2d`` of the
   scene of ``tests/test_torch_detection2d.py`` and at the shape of
   ``tests/data/torch_a13_fixture.npz``: 100 objects, 512 hypotheses)
   contract those fusions, and those of Ferrari's solution, the polishes
   and the first distances (``STAGE_FUSIONS``), as the standalone
   ``vmap(p3p)`` does;
3. how far the model reproduces the whole program (R, T, valid).

With ``--oracle`` the model matches every fusion of ``vmap(p3p)`` through
Ferrari's solution and the six polishes of the roots and the first
distance; it misses the other distances (their interleaved concatenate:
``cg * cg`` is not contracted there), the Newton step's J (unfused) and
F (``fma(-(2 x y), cos, fma(x, x, y y))``), read instead by trying
candidates against the compiled fusions, and the Horn fit's fusions. The
port transcribes P3P through the Newton steps (``geometry/pnp.py``).
:func:`compiled_trace` runs the entry with every fusion by XLA's own
object code, which ``tests/test_torch_pnp.py`` holds the port's roots
to.

``--oracle`` links each fusion's dumped object file into a shared library
and calls it (XLA:CPU's kernel call frame) on the model's own inputs:
the compiled reference's arithmetic fusion by fusion, so each fusion the
model gets wrong shows by name (a fusion whose output aliases its input,
the loop states', shows as 0 within 1e-3: not a modelling error).
It exits with status 1 if stage 1 misses a bit or a 2D path program
contracts a coefficient fusion otherwise.
"""

from __future__ import annotations

import argparse
import ctypes
import glob
import os
import re
import subprocess
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

from tod_tpu_torch.ops import libm  # noqa: E402

f32 = np.float32
DT = {"f32": np.float32, "s32": np.int32, "pred": np.bool_, "u32": np.uint32,
      "s64": np.int64, "u8": np.uint8, "f64": np.float64}


def fma(a, b, c):
    a, b, c = np.broadcast_arrays(np.asarray(a, f32), np.asarray(b, f32),
                                  np.asarray(c, f32))
    p = a.astype(np.float64) * b.astype(np.float64)
    cc = c.astype(np.float64)
    with np.errstate(all="ignore"):
        s = p + cc
        back = s - p
        err = (p - (s - back)) + (cc - back)
    bits = s.view(np.int64).copy()
    adj = (err != 0) & (err == err) & ((bits & 1) == 0) & np.isfinite(s)
    bits[adj] += np.where((err > 0) == (s > 0), 1, -1)[adj]
    return bits.view(np.float64).astype(f32)


def parse_type(t):
    """'f32[64,8]{1,0}' -> (dtype, shape, layout); tuples -> ('tuple',...)"""
    m = re.match(r"(\w+)\[([\d,]*)\](?:\{([\d,]*)\})?", t)
    dt = m.group(1)
    shape = tuple(int(x) for x in m.group(2).split(",") if x)
    layout = tuple(int(x) for x in m.group(3).split(",") if x) if m.group(3) else tuple(range(len(shape) - 1, -1, -1))
    return dt, shape, layout


class Instr:
    pass


LINE = re.compile(r"^\s*(ROOT )?%(\S+) = (.+?) ([a-z][a-z0-9-]*)\((.*)$")


def parse_module(text):
    comps, order = {}, []
    cur, name = None, None
    for raw in text.splitlines():
        line = re.sub(r", metadata=\{[^}]*\}", "", raw)
        line = re.sub(r", frontend_attributes=\{.*?\}(?=, |$)", "", line)
        h = re.match(r"^(ENTRY )?%(\S+) \(.*\{$", line)
        if h:
            name = h.group(2)
            cur = []
            comps[name] = cur
            if h.group(1):
                comps["__entry__"] = name
            continue
        if line.startswith("}"):
            cur = None
            continue
        if cur is None:
            continue
        m = LINE.match(line)
        if not m:
            continue
        ins = Instr()
        ins.root = bool(m.group(1))
        ins.name = m.group(2)
        ins.type = m.group(3)
        ins.op = m.group(4)
        rest = m.group(5)
        depth, i = 1, 0
        while depth:
            if rest[i] == "(":
                depth += 1
            elif rest[i] == ")":
                depth -= 1
            i += 1
        ins.args_raw = rest[:i - 1]
        ins.attrs = rest[i:]
        ins.operands = re.findall(r"%([\w.\-]+)", ins.args_raw)
        cur.append(ins)
    return comps


def attr(ins, key):
    m = re.search(key + r"=(\{[^}]*\}|[^,\s]+)", ins.attrs)
    return m.group(1) if m else None


def ints(s):
    return [int(x) for x in re.findall(r"-?\d+", s or "")]


def to_phys(x, layout):
    return np.transpose(x, list(reversed(layout))).ravel()


def from_phys(p, shape, layout):
    major = list(reversed(layout))
    arr = p.reshape([shape[d] for d in major])
    inv = np.argsort(major)
    return np.transpose(arr, inv)


VIEW = {"broadcast", "bitcast", "reshape", "copy", "slice", "transpose"}




class Interp:
    def __init__(self, text, lapack=None, gemv_dot=None):
        self.comps = parse_module(text)
        fused = set(re.findall(r"calls=%([\w.\-]+)", text))
        for name in fused:
            if name in self.comps:
                self.comps[name] = hoist_selects(self.comps[name])
        self.lapack = lapack
        self.types = {}
        for cname, instrs in self.comps.items():
            if cname == "__entry__":
                continue
            for ins in instrs:
                self.types[(cname, ins.name)] = ins.type
        self.gemv_dot = gemv_dot
        self.trace = {}

    def run(self, *args):
        return self.call(self.comps["__entry__"], list(args))

    def call(self, cname, args):
        """A computation outside fusions (the entry, loop bodies,
        reducers), op by op."""
        instrs = self.comps[cname]
        env = {}
        for ins in instrs:
            env[ins.name] = self.eval(ins, env, args, cname)
            if cname == self.comps["__entry__"]:
                self.trace[ins.name] = env[ins.name]
        return env[[i for i in instrs if i.root][0].name]

    def view(self, ins, x):
        dt, shape, layout = parse_type(ins.type)
        if ins.op == "broadcast":
            dims = ints(attr(ins, "dimensions"))
            x = np.asarray(x)
            newshape = [1] * len(shape)
            for i, d in enumerate(dims):
                newshape[d] = x.shape[i]
            return np.broadcast_to(x.reshape(newshape), shape)
        if ins.op in ("bitcast", "reshape"):
            src = self.cur_types[ins.operands[0]]
            sdt, sshape, slayout = parse_type(src)
            if ins.op == "reshape":
                return np.asarray(x).reshape(shape)
            return from_phys(to_phys(np.asarray(x), slayout), shape, layout)
        if ins.op == "copy":
            return np.asarray(x)
        if ins.op == "slice":
            sl = re.findall(r"\[(\d+):(\d+)(?::(\d+))?\]", attr(ins, "slice") or ins.attrs)
            idx = tuple(slice(int(a), int(b), int(c) if c else 1) for a, b, c in sl)
            return np.asarray(x)[idx]
        if ins.op == "transpose":
            return np.transpose(x, ints(attr(ins, "dimensions")))
        raise NotImplementedError(ins.op)

    def eval(self, ins, env, args, cname):
        self.cur_types = {i.name: i.type for i in self.comps[cname]}
        op = ins.op
        A = [env[o] if o in env else None for o in ins.operands]
        ty = ins.type
        if op == "parameter":
            return args[int(ins.args_raw)]
        if op == "constant":
            dt, shape, _ = parse_type(ty)
            raw = ins.args_raw.strip()
            if shape == ():
                v = {"nan": np.nan, "inf": np.inf, "-inf": -np.inf, "true": True, "false": False}.get(raw, None)
                if v is None:
                    v = float(raw) if dt in ("f32", "f64") else int(raw)
                return np.asarray(v, DT[dt])
            vals = re.findall(r"-?[\d.e+\-]+|nan|inf|true|false", raw)
            return np.array([float(v) for v in vals], DT[dt]).reshape(shape)
        if op in VIEW:
            return self.view(ins, A[0])
        if op == "tuple":
            return tuple(A)
        if op == "get-tuple-element":
            return A[0][int(attr(ins, "index"))]
        if op == "fusion":
            called = re.search(r"calls=%([\w.\-]+)", ins.attrs).group(1)
            out = self.call_fused(called, A)
            self.trace[ins.name] = out
            return out
        if op == "while":
            cond = re.search(r"condition=%([\w.\-]+)", ins.attrs).group(1)
            body = re.search(r"body=%([\w.\-]+)", ins.attrs).group(1)
            state, trips = A[0], 0
            while bool(self.call(cond, [state])):
                state = self.call(body, [state])
                trips += 1
                if trips > 10000:
                    raise RuntimeError(f"{ins.name}: no end after {trips} trips")
            return state
        if op == "custom-call":
            return self.lapack(ins, A, self)
        dt, shape, layout = parse_type(ty) if not ty.startswith("(") else (None, None, None)
        with np.errstate(all="ignore"):
            if op in ("add", "subtract"):
                return (A[0] + A[1] if op == "add" else A[0] - A[1]).astype(DT[dt])
            if op == "multiply":
                return (A[0] * A[1]).astype(DT[dt])
            if op == "divide":
                if dt == "f32":
                    return (A[0] / A[1]).astype(f32)
                q = np.trunc(A[0] / A[1]).astype(DT[dt])
                return q
            if op == "negate":
                return (-A[0]).astype(DT[dt])
            if op == "abs":
                return np.abs(A[0])
            if op == "sqrt":
                return np.sqrt(A[0]).astype(f32)
            if op == "rsqrt":
                return rsqrt_xla(A[0])
            if op == "maximum":
                return np.maximum(A[0], A[1])
            if op == "minimum":
                return np.minimum(A[0], A[1])
            if op == "clamp":
                return np.minimum(np.maximum(A[1], A[0]), A[2])
            if op == "select":
                return np.where(A[0], A[1], A[2]).astype(DT[dt])
            if op == "compare":
                d = attr(ins, "direction")
                fn = {"LT": np.less, "LE": np.less_equal, "GT": np.greater, "GE": np.greater_equal, "EQ": np.equal, "NE": np.not_equal}[d]
                return fn(A[0], A[1])
            if op == "and":
                return A[0] & A[1]
            if op == "or":
                return A[0] | A[1]
            if op == "not":
                return ~A[0]
            if op == "xor":
                return A[0] ^ A[1]
            if op == "is-finite":
                return np.isfinite(A[0])
            if op == "sign":
                x = A[0]
                return np.where(x > 0, f32(1), np.where(x < 0, f32(-1), x)).astype(f32)
            if op == "convert":
                return np.asarray(A[0]).astype(DT[dt])
            if op == "iota":
                d = int(attr(ins, "iota_dimension"))
                r = np.arange(shape[d], dtype=DT[dt])
                sh = [1] * len(shape)
                sh[d] = shape[d]
                return np.broadcast_to(r.reshape(sh), shape).copy()
            if op == "power":
                x, y = np.broadcast_arrays(A[0], A[1])
                return libm.powf_torch(torch.from_numpy(np.ascontiguousarray(x, f32)), torch.from_numpy(np.ascontiguousarray(y, f32))).numpy()
            if op == "cosine":
                return libm.cosf_torch(torch.from_numpy(np.ascontiguousarray(A[0], f32))).numpy()
            if op == "sine":
                return libm.sincosf_torch(torch.from_numpy(np.ascontiguousarray(A[0], f32)))[0].numpy()
            if op == "atan2":
                y, x = np.broadcast_arrays(A[0], A[1])
                return libm.atan2f_torch(torch.from_numpy(np.ascontiguousarray(y, f32)), torch.from_numpy(np.ascontiguousarray(x, f32))).numpy()
            if op == "concatenate":
                return np.concatenate([np.broadcast_to(a, a.shape) for a in A], axis=ints(attr(ins, "dimensions"))[0])
            if op == "reduce":
                return self.reduce(ins, A)
            if op == "dot":
                return self.dot(ins, A)
            if op == "gather":
                return self.gather(ins, A)
            if op == "scatter":
                return self.scatter(ins, A)
            if op == "dynamic-slice":
                sizes = ints(attr(ins, "dynamic_slice_sizes"))
                starts = [int(np.clip(int(s), 0, A[0].shape[i] - sizes[i])) for i, s in enumerate(A[1:])]
                return A[0][tuple(slice(s, s + z) for s, z in zip(starts, sizes))]
            if op == "dynamic-update-slice":
                out = np.array(A[0])
                upd = A[1]
                starts = [int(np.clip(int(s), 0, out.shape[i] - upd.shape[i])) for i, s in enumerate(A[2:])]
                out[tuple(slice(s, s + z) for s, z in zip(starts, upd.shape))] = upd
                return out
            if op == "pad":
                raise NotImplementedError
        raise NotImplementedError(op)

    def reduce(self, ins, A):
        dims = ints(attr(ins, "dimensions"))
        to_apply = re.search(r"to_apply=%([\w.\-]+)", ins.attrs).group(1)
        n = len(A) // 2
        ops, inits = A[:n], A[n:]
        body = self.comps[to_apply]
        root = [i for i in body if i.root][0]
        keep = [d for d in range(ops[0].ndim) if d not in dims]
        xs = [np.moveaxis(np.asarray(o), dims, list(range(len(dims)))) for o in ops]
        out_shape = xs[0].shape[len(dims):]
        flat = [x.reshape((-1,) + out_shape) for x in xs]
        acc = [np.broadcast_to(i, out_shape).copy() for i in inits]
        simple_add = n == 1 and root.op == "add" and len(body) == 3
        for k in range(flat[0].shape[0]):
            if simple_add:
                with np.errstate(all="ignore"):
                    acc = [(acc[0] + flat[0][k]).astype(acc[0].dtype)]
            else:
                res = self.call(to_apply, acc + [f[k] for f in flat])
                acc = list(res) if isinstance(res, tuple) else [res]
        return tuple(acc) if n > 1 else acc[0]

    def dot(self, ins, A):
        lb, lc = ints(attr(ins, "lhs_batch_dims")), ints(attr(ins, "lhs_contracting_dims"))
        rb, rc = ints(attr(ins, "rhs_batch_dims")), ints(attr(ins, "rhs_contracting_dims"))
        x, y = np.asarray(A[0]), np.asarray(A[1])
        lf = [d for d in range(x.ndim) if d not in lb + lc]
        rf = [d for d in range(y.ndim) if d not in rb + rc]
        X = np.transpose(x, lb + lf + lc)
        Y = np.transpose(y, rb + rf + rc)
        K = int(np.prod([x.shape[d] for d in lc]))
        bs = [x.shape[d] for d in lb]
        X = X.reshape(bs + [x.shape[d] for d in lf] + [K])
        Y = Y.reshape(bs + [y.shape[d] for d in rf] + [K])
        Xe = X.reshape(bs + [x.shape[d] for d in lf] + [1] * len(rf) + [K])
        Ye = Y.reshape(bs + [1] * len(lf) + [y.shape[d] for d in rf] + [K])
        mode = self.gemv_dot(ins) if self.gemv_dot else "chain0"
        with np.errstate(all="ignore"):
            if mode == "chain0":
                acc = np.zeros(np.broadcast_shapes(Xe.shape[:-1], Ye.shape[:-1]), f32)
                for k in range(K):
                    acc = fma(Xe[..., k], Ye[..., k], acc)
            else:
                acc = (Xe[..., 0] * Ye[..., 0]).astype(f32)
                for k in range(1, K):
                    acc = (acc + (Xe[..., k] * Ye[..., k]).astype(f32)).astype(f32)
        return acc

    def gather(self, ins, A):
        operand, idx = np.asarray(A[0]), np.asarray(A[1])
        offset_dims = ints(attr(ins, "offset_dims"))
        collapsed = ints(attr(ins, "collapsed_slice_dims"))
        smap = ints(attr(ins, "start_index_map"))
        ivd = int(attr(ins, "index_vector_dim"))
        sizes = ints(attr(ins, "slice_sizes"))
        dt, shape, _ = parse_type(ins.type)
        if ivd == idx.ndim:
            idx = idx[..., None]
        idx = np.moveaxis(idx, ivd, -1)
        batch_shape = idx.shape[:-1]
        out = np.empty(shape, operand.dtype)
        batch_dims = [d for d in range(len(shape)) if d not in offset_dims]
        offs_operand = [d for d in range(operand.ndim) if d not in collapsed]
        for bi in np.ndindex(*batch_shape):
            start = [0] * operand.ndim
            for k, d in enumerate(smap):
                start[d] = int(np.clip(idx[bi][k], 0, operand.shape[d] - sizes[d]))
            sl = operand[tuple(slice(s, s + z) for s, z in zip(start, sizes))]
            sl = sl.reshape([sizes[d] for d in offs_operand])
            o_idx = [slice(None)] * len(shape)
            for k, d in enumerate(batch_dims):
                o_idx[d] = bi[k]
            out[tuple(o_idx)] = sl
        return out

    def scatter(self, ins, A):
        operand, idx, upd = np.array(A[0]), np.asarray(A[1]), np.asarray(A[2])
        uwd = ints(attr(ins, "update_window_dims"))
        iwd = ints(attr(ins, "inserted_window_dims"))
        sd = ints(attr(ins, "scatter_dims_to_operand_dims"))
        ivd = int(attr(ins, "index_vector_dim"))
        if ivd == idx.ndim:
            idx = idx[..., None]
        idx = np.moveaxis(idx, ivd, -1)
        batch_shape = idx.shape[:-1]
        ubatch = [d for d in range(upd.ndim) if d not in uwd]
        window = [upd.shape[d] for d in uwd]
        win_operand = [d for d in range(operand.ndim) if d not in iwd]
        for bi in np.ndindex(*batch_shape):
            u_idx = [slice(None)] * upd.ndim
            for k, d in enumerate(ubatch):
                u_idx[d] = bi[k]
            u = upd[tuple(u_idx)]
            start = [0] * operand.ndim
            for k, d in enumerate(sd):
                start[d] = int(idx[bi][k])
            sizes = [1] * operand.ndim
            for k, d in enumerate(win_operand):
                sizes[d] = window[k]
            operand[tuple(slice(s, s + z) for s, z in zip(start, sizes))] = u.reshape(sizes)
        return operand



def hoist_selects(instrs):
    """InstCombine's ``select(c, x - z, y - z)`` -> ``select(c, x, y) - z``
    (also for add and multiply, the shared operand on either side where
    the op commutes), each arm used by the select alone; dead arms dropped.
    Returns the rewritten instruction list."""
    users = {}
    for ins in instrs:
        for o in ins.operands:
            users[o] = users.get(o, 0) + 1
    byname = {i.name: i for i in instrs}
    out, changed = [], False
    for ins in instrs:
        if ins.op == "select" and len(ins.operands) == 3:
            pr, a, b = ins.operands
            A, B = byname.get(a), byname.get(b)
            if A is not None and B is not None and A.op == B.op \
                    and A.op in ("add", "subtract", "multiply") \
                    and users.get(a) == 1 and users.get(b) == 1 and a != b:
                shared = None
                if A.operands[1] == B.operands[1]:
                    shared, xa, xb, side = A.operands[1], A.operands[0], B.operands[0], 1
                elif A.op != "subtract" and A.operands[0] == B.operands[0]:
                    shared, xa, xb, side = A.operands[0], A.operands[1], B.operands[1], 0
                if shared is not None:
                    sel = Instr()
                    sel.root, sel.name, sel.type, sel.op = False, ins.name + "_hoisted", ins.type, "select"
                    sel.operands, sel.args_raw, sel.attrs = [pr, xa, xb], "", ""
                    new = Instr()
                    new.root, new.name, new.type, new.op = ins.root, ins.name, ins.type, A.op
                    new.operands = [sel.name, shared] if side == 1 else [shared, sel.name]
                    new.args_raw, new.attrs = "", ""
                    out += [sel, new]
                    changed = True
                    continue
        out.append(ins)
    if not changed:
        return instrs
    while True:                                  # drop the dead arms
        users = {}
        for ins in out:
            for o in ins.operands:
                users[o] = users.get(o, 0) + 1
        keep = [i for i in out if i.root or users.get(i.name) or i.op == "parameter"]
        if len(keep) == len(out):
            return out
        out = keep


RSQRT_C = r"""
#include <immintrin.h>
void rsq(const float* x, float* y, long n) {
  for (long i = 0; i < n; ++i)
    _mm_store_ss(y + i, _mm_rsqrt_ss(_mm_set_ss(x[i])));
}
"""


def rsqrtps_table() -> np.ndarray:
    """This host's ``rsqrtps`` as a (2, 1024) uint32 table: its result's
    bits for 2^p * (1 + m / 1024), p = 0, 1 (it reads the exponent's
    parity and the mantissa's top 10 bits; other exponents shift the
    result's: :func:`rsqrt_xla`)."""
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "rsq.c")
        open(src, "w").write(RSQRT_C)
        so = os.path.join(tmp, "rsq.so")
        subprocess.run(["gcc", "-O2", "-mavx", "-shared", "-fPIC", "-o", so,
                        src], check=True)
        fn = ctypes.CDLL(so).rsq
        top = np.arange(1024, dtype=np.uint32)
        out = []
        for p in (0, 1):
            x = ((np.uint32(127 + p) << 23) | (top << 13)).view(np.float32)
            y = np.empty_like(x)
            fn(x.ctypes.data_as(ctypes.c_void_p),
               y.ctypes.data_as(ctypes.c_void_p), ctypes.c_long(len(x)))
            out.append(y.view(np.uint32))
    return np.stack(out)


_RSQRT = []


def rsqrt_xla(x) -> np.ndarray:
    """XLA:CPU's rsqrt: ``rsqrtps`` then two Newton steps, contracted as its
    IR is (``y' = fma(y (-1/2), fma(x y, y, -1), y)``); zeros, subnormals
    and +inf keep the hardware's estimate."""
    if not _RSQRT:
        _RSQRT.append(rsqrtps_table())
    table = _RSQRT[0]
    x = np.asarray(x, np.float32)
    b = x.view(np.uint32)
    e = ((b >> 23) & 0xFF).astype(np.int64) - 127
    par = e & 1
    y0 = (table[par, (b >> 13) & 1023].astype(np.int64)
          - (((e - par) // 2) << 23)).astype(np.uint32).view(np.float32)
    y = y0
    with np.errstate(all="ignore"):
        for _ in range(2):
            y = fma((y * np.float32(-0.5)).astype(np.float32),
                    fma((x * y).astype(np.float32), y, np.float32(-1)), y)
    special = (x == 0) | (np.isinf(x) & (x > 0)) | (
        (np.abs(x) < np.finfo(np.float32).tiny) & (x > 0))
    return np.where(special | ~(x > 0), y0, y).astype(np.float32)


ARITH = {"add", "subtract", "multiply", "divide", "negate"}
UNMOVABLE = {"power", "atan2", "cosine", "sine", "exponential", "log",
             "log-plus-one", "exponential-minus-one", "tanh"}


def _ranks(instrs):
    """LLVM Reassociate's ranks: loads (and calls) numbered in the order
    the elemental emitter reaches them (a post-order walk from the root,
    operands left to right), an expression one above its highest operand
    (a negation not counted), constants 0."""
    byname = {i.name: i for i in instrs}
    rank, counter = {}, [1 << 16]
    sys.setrecursionlimit(100000)

    def visit(n):
        if n in rank:
            return rank[n]
        ins = byname[n]
        if ins.op == "parameter":
            counter[0] += 1
            r = counter[0]
        elif ins.op == "constant":
            r = 0
        elif ins.op in VIEW:
            r = visit(ins.operands[0])
        elif ins.op in UNMOVABLE:
            for o in ins.operands:
                visit(o)
            counter[0] += 1
            r = counter[0]
        elif ins.op == "negate":
            r = visit(ins.operands[0])
        else:
            r = max([visit(o) for o in ins.operands] + [0]) + 1
        rank[n] = r
        return r

    for ins in instrs:
        if ins.root:
            visit(ins.name)
    for ins in instrs:
        visit(ins.name)
    return rank


def _resolve(self, cname):
    instrs = self.comps[cname]
    nodes, node_info, struct, form, negs, folded = {}, [], {}, {}, {}, {}
    rank = _ranks(instrs)
    byname_all = {i.name: i for i in instrs}

    def intern(key, op, kids):
        if key not in nodes:
            nodes[key] = len(node_info)
            node_info.append((op, kids))
        return nodes[key]

    for ins in instrs:
        dt = ins.type.split("[")[0]
        tup = ins.type.startswith("(")
        if ins.op in VIEW and dt == "f32" and ins.operands and ins.operands[0] in struct:
            struct[ins.name] = struct[ins.operands[0]]
            continue
        if dt == "f32" and not tup and ins.op in ARITH:
            if ins.op == "negate":
                c, sg = struct[ins.operands[0]]
                if sg < 0:                 # -(X * -C) is X * C
                    struct[ins.name] = (c, 1)
                else:                      # an fneg that stays one
                    struct[ins.name] = (intern(("neg", c), ("neg", c), [c]), 1)
                    negs[ins.name] = ins.operands[0]
                continue
            (ca, sa), (cb, sb) = struct[ins.operands[0]], struct[ins.operands[1]]
            if ins.op == "multiply":
                k = ("mul",) + tuple(sorted((ca, cb)))
                struct[ins.name] = (intern(k, ("mul", ca, cb), [ca, cb]), sa * sb)
                continue
            if ins.op == "divide":
                struct[ins.name] = (intern(("div", ca, cb), ("div", ca, cb), [ca, cb]), sa * sb)
                continue
            o0, o1 = ins.operands
            op = ins.op
            # InstCombine: (-X) + Y is Y - X, X + (-Y) is X - Y, X - (-Y)
            # is X + Y
            if op == "add" and o0 in negs:
                folded[o0] = folded.get(o0, 0) + 1
                op, o0, o1 = "subtract", o1, negs[o0]
            elif op == "add" and o1 in negs:
                folded[o1] = folded.get(o1, 0) + 1
                op, o1 = "subtract", negs[o1]
            elif op == "subtract" and o1 in negs:
                folded[o1] = folded.get(o1, 0) + 1
                op, o1 = "add", negs[o1]
            (ca, sa), (cb, sb) = struct[o0], struct[o1]
            if op == "add":
                tab = {(1, 1): ("add", o0, o1, 1), (1, -1): ("sub", o0, o1, 1),
                       (-1, 1): ("sub", o1, o0, 1), (-1, -1): ("add", o0, o1, -1)}
            else:
                tab = {(1, 1): ("sub", o0, o1, 1), (1, -1): ("add", o0, o1, 1),
                       (-1, 1): ("add", o0, o1, -1), (-1, -1): ("sub", o1, o0, 1)}
            f, L, R, sg = tab[(sa, sb)]
            lc = byname_all[L].op == "constant" or (byname_all[L].op == "broadcast" and byname_all[byname_all[L].operands[0]].op == "constant")
            rc = byname_all[R].op == "constant" or (byname_all[R].op == "broadcast" and byname_all[byname_all[R].operands[0]].op == "constant")
            if f == "add" and not rc and (lc or rank[R] < rank[L]):      # Reassociate's order
                L, R = R, L
            cl, cr = struct[L][0], struct[R][0]
            k = (f,) + (tuple(sorted((cl, cr))) if f == "add" else (cl, cr))
            cid = intern(k, (f, cl, cr), [cl, cr])
            struct[ins.name] = (cid, sg)
            # GVN keeps the first of equal values: its operand order
            fl, fr = node_info[cid][0][1], node_info[cid][0][2]
            form[ins.name] = (f, L, R) if (cl, cr) == (fl, fr) else (f, R, L)
            continue
        ks = tuple(struct.get(o, (o, 1)) for o in ins.operands)
        raw = ins.args_raw if ins.op in ("parameter", "constant") else ""
        sg = 1
        if ins.op == "constant" and dt == "f32" and ins.type.startswith("f32[]"):
            v = float(raw.strip())
            if v < 0:
                sg = -1
            raw = repr(abs(v)) if v == v else "nan"
        k = ("leaf", ins.op, ks, re.sub(r"\{[\d,]*\}", "", ins.type),
             re.sub(r"%[\w.\-]+", "", ins.attrs), raw)
        struct[ins.name] = (intern(k, ("leaf", ins.name), [c for c, _ in ks if isinstance(c, int)]), sg)
    # an fneg whose every user folded it away (into a subtract) is gone
    users = {}
    for ins in instrs:
        for o in ins.operands:
            users[o] = users.get(o, 0) + 1
    dead = {struct[n][0] for n, k in folded.items() if k == users.get(n, 0)}
    uses = {}
    for cid, (op, kids) in enumerate(node_info):
        if cid in dead:
            continue
        for c in kids:
            uses[c] = uses.get(c, 0) + 1
    for ins in instrs:
        if ins.root:
            outs = ins.operands if ins.type.startswith("(") else [ins.name]
            for o in outs:
                c = struct[o][0]
                uses[c] = uses.get(c, 0) + 1
    return struct, node_info, uses, form, negs


def _concat_regions(instrs):
    """A concatenate under the root (through views): XLA emits each of its
    operands in a region of its own (no value shared between them), so
    each is modelled apart. Returns (concatenate, [operand names]) or
    None."""
    byname = {i.name: i for i in instrs}
    n = [i for i in instrs if i.root][0]
    while n.op in VIEW and n.operands:
        n = byname[n.operands[0]]
    if n.op == "concatenate":
        return n, list(n.operands)
    return None


def _subtree(instrs, root: str):
    """The instructions ``root`` depends on, in order, ``root`` the ROOT."""
    byname = {i.name: i for i in instrs}
    need, todo = set(), [root]
    while todo:
        x = todo.pop()
        if x in need or x not in byname:
            continue
        need.add(x)
        todo.extend(byname[x].operands)
    out = []
    for i in instrs:
        if i.name in need:
            j = Instr()
            j.__dict__.update(i.__dict__)
            j.root = i.name == root
            out.append(j)
    return out


def call_fused(self, cname, args):
    regions = _concat_regions(self.comps[cname])
    if regions is not None and not cname.endswith("#region"):
        cat, parts = regions
        instrs = self.comps[cname]
        pieces = []
        for k, part in enumerate(parts):
            sub = f"{cname}#{k}#region"
            self.comps[sub] = _subtree(instrs, part)
            pieces.append(np.asarray(self._call_fused(sub, args)))
        out = np.concatenate(pieces, axis=ints(attr(cat, "dimensions"))[0])
        byname = {i.name: i for i in instrs}
        chain, n = [], [i for i in instrs if i.root][0]
        while n.name != cat.name:
            chain.append(n)
            n = byname[n.operands[0]]
        self.cur_types = {i.name: i.type for i in instrs}
        for view in reversed(chain):
            out = self.view(view, out)
        return out
    return self._call_fused(cname, args)


def _call_fused(self, cname, args):
    instrs = self.comps[cname]
    struct, node_info, uses, form, negs = _resolve(self, cname)
    byname = {i.name: i for i in instrs}
    self.cur_types = {i.name: i.type for i in instrs}
    absval, env = {}, {}

    def mul_operands(name):
        chain, n = [], name
        while byname[n].op in VIEW or byname[n].op == "negate":
            if byname[n].op in VIEW:
                chain.append(byname[n])
            n = byname[n].operands[0]
        mul = byname[n]
        assert mul.op == "multiply", mul.op
        out = []
        for o in mul.operands:
            v = np.broadcast_to(absval[o], np.shape(absval[n]))
            for c in reversed(chain):
                v = self.view(c, v)
            out.append(np.asarray(v))
        return out

    def is_dbl(cid):
        op = node_info[cid][0]
        for k in (op[1], op[2]):
            lop = node_info[k][0]
            if lop[0] == "leaf":
                base = byname[lop[1]]
                while base.op == "broadcast":
                    base = byname[base.operands[0]]
                if base.op == "constant" and base.args_raw.strip() in ("2", "-2"):
                    return True
        return False

    def contractable(cid):
        return node_info[cid][0][0] == "mul" and uses.get(cid, 0) == 1 and not is_dbl(cid)

    for ins in instrs:
        dt = ins.type.split("[")[0]
        tup = ins.type.startswith("(")
        f32op = dt == "f32" and not tup
        if f32op and ins.op in VIEW and ins.operands[0] in absval:
            absval[ins.name] = self.view(ins, absval[ins.operands[0]])
        elif f32op and ins.op == "negate":
            absval[ins.name] = (np.asarray(-absval[ins.operands[0]], f32)
                                if ins.name in negs
                                else absval[ins.operands[0]])
        elif f32op and ins.op in ("multiply", "divide"):
            a, b = (absval[o] for o in ins.operands)
            with np.errstate(all="ignore"):
                absval[ins.name] = np.asarray((a * b) if ins.op == "multiply" else (a / b), f32)
        elif f32op and ins.op in ("add", "subtract"):
            f, L, R = form[ins.name]
            cl, cr = struct[L][0], struct[R][0]
            lv, rv = absval[L], absval[R]
            with np.errstate(all="ignore"):
                if contractable(cl):
                    a, b = mul_operands(L)
                    out = fma(a, b, rv if f == "add" else -rv)
                elif contractable(cr):
                    a, b = mul_operands(R)
                    out = fma(a if f == "add" else -a, b, lv)
                else:
                    out = (lv + rv) if f == "add" else (lv - rv)
            absval[ins.name] = np.asarray(out, f32)
        elif ins.op == "reduce" and len(ins.operands) == 2 and dt == "f32" and contractable(struct[ins.operands[0]][0]):
            body = self.comps[re.search(r"to_apply=%([\w.\-]+)", ins.attrs).group(1)]
            assert [i for i in body if i.root][0].op == "add"
            dims = ints(attr(ins, "dimensions"))
            a, b = mul_operands(ins.operands[0])
            sgn = struct[ins.operands[0]][1]
            a = np.moveaxis(a, dims, list(range(len(dims))))
            b = np.moveaxis(b, dims, list(range(len(dims))))
            a = a.reshape((-1,) + a.shape[len(dims):])
            b = b.reshape((-1,) + b.shape[len(dims):])
            acc = np.broadcast_to(env[ins.operands[1]], a.shape[1:]).astype(f32)
            for k in range(a.shape[0]):
                acc = fma(-a[k] if sgn < 0 else a[k], b[k], acc)
            env[ins.name] = acc
            absval[ins.name] = acc
            continue
        else:
            val = self.eval(ins, env, args, cname)
            env[ins.name] = val
            if f32op:
                sg = struct[ins.name][1]
                absval[ins.name] = np.asarray(-np.asarray(val), f32) if sg < 0 else np.asarray(val)
            continue
        sg = struct[ins.name][1]
        env[ins.name] = np.asarray(-absval[ins.name], f32) if sg < 0 else absval[ins.name]
    root = [i for i in instrs if i.root][0]
    return env[root.name]


Interp.call_fused = call_fused
Interp._call_fused = _call_fused


def express(self, cname, pnames):
    """The fusion's root as a contracted expression string (value = sign *
    |expr|): fma(a, b, c), products, sums, in the backend's order."""
    instrs = self.comps[cname]
    struct, node_info, uses, form, negs = _resolve(self, cname)
    byname = {i.name: i for i in instrs}
    ab = {}

    def is_dbl(cid):
        op = node_info[cid][0]
        for k in (op[1], op[2]):
            lop = node_info[k][0]
            if lop[0] == "leaf":
                base = byname[lop[1]]
                while base.op == "broadcast":
                    base = byname[base.operands[0]]
                if base.op == "constant" and base.args_raw.strip() in ("2", "-2"):
                    return True
        return False

    def contractable(cid):
        return node_info[cid][0][0] == "mul" and uses.get(cid, 0) == 1 and not is_dbl(cid)

    def mulops(n):
        while byname[n].op in VIEW or byname[n].op == "negate":
            n = byname[n].operands[0]
        return [ab[o] for o in byname[n].operands]

    for ins in instrs:
        sg = struct.get(ins.name, (0, 1))[1]
        if ins.op == "parameter":
            ab[ins.name] = pnames[int(ins.args_raw)]
        elif ins.op == "constant":
            v = ins.args_raw.strip()
            ab[ins.name] = v.lstrip("-")
        elif ins.op in VIEW or ins.op == "negate":
            ab[ins.name] = (f"(-{ab[ins.operands[0]]})" if ins.name in negs
                            else ab[ins.operands[0]])
        elif ins.op == "multiply":
            a, b = (ab[o] for o in ins.operands)
            ab[ins.name] = f"({a} * {b})"
        elif ins.op == "divide":
            a, b = (ab[o] for o in ins.operands)
            ab[ins.name] = f"({a} / {b})"
        elif ins.op in ("add", "subtract") and ins.name in form:
            f, L, R = form[ins.name]
            cl, cr = struct[L][0], struct[R][0]
            if contractable(cl):
                a, b = mulops(L)
                ab[ins.name] = f"fma({a}, {b}, {'' if f == 'add' else '-'}{ab[R]})"
            elif contractable(cr):
                a, b = mulops(R)
                ab[ins.name] = f"fma({'' if f == 'add' else '-'}{a}, {b}, {ab[L]})"
            else:
                ab[ins.name] = f"({ab[L]} {'+' if f == 'add' else '-'} {ab[R]})"
        else:
            ab[ins.name] = f"{ins.op}({', '.join(ab.get(o, o) for o in ins.operands)})"
        if sg < 0 and ins.op not in ("add", "subtract", "multiply", "divide", "negate") and ins.op not in VIEW:
            pass
    root = [i for i in instrs if i.root][0]
    return ("-" if struct[root.name][1] < 0 else "") + ab[root.name]


Interp.express = express


# --- XLA's own compiled fusions as per-fusion oracles ----------------------

class _Dim(ctypes.Structure):
    _fields_ = [("x", ctypes.c_uint64), ("y", ctypes.c_uint64),
                ("z", ctypes.c_uint64)]


class _Arg(ctypes.Structure):
    _fields_ = [("data", ctypes.c_void_p), ("size", ctypes.c_size_t)]


class _Frame(ctypes.Structure):
    """XLA:CPU's kernel call frame (kernel_c_api.h): the workgroup count,
    this workgroup's id, the arguments (inputs, then outputs)."""
    _fields_ = [("num_workgroups", ctypes.POINTER(_Dim)),
                ("workgroup_id", ctypes.POINTER(_Dim)),
                ("num_args", ctypes.c_size_t),
                ("args", ctypes.POINTER(_Arg))]


class Oracle:
    """The dumped object file of each fusion (``*obj-file.<name>_kernel_
    module.o``), linked into a shared library and called through its call
    frame: the compiled reference's own arithmetic on any inputs."""

    def __init__(self, dumpdir: str, workdir: str):
        self.dumpdir, self.workdir, self.fns = dumpdir, workdir, {}

    def _workgroups(self, module: str) -> int:
        ll = glob.glob(os.path.join(self.dumpdir, f"*.{module}.ir-with-opt.ll"))
        if not ll:
            return 1
        text = open(ll[0]).read()
        m = re.search(r"(%\w+) = getelementptr inbounds nuw i8, ptr %0, i64 "
                      r"8\n\s*(%\w+) = load ptr, ptr \1.*\n\s*(%\w+) = load "
                      r"i64, ptr \2", text)
        if not m:
            return 1
        count = 1
        for pred, c in re.findall(rf"icmp (\w+) i64 {re.escape(m.group(3))}, "
                                  r"(-?\d+)", text):
            c = int(c)
            if pred == "eq":
                count = max(count, c + 1)
            elif pred in ("slt", "ult"):
                count = max(count, c)
        return count

    def __call__(self, name: str, inputs, out_type: str, init=None):
        """The fusion ``name``'s output (logical order) on ``inputs``
        ((array, HLO type) pairs), or None without an object file. ``init``
        (an input of the output's type) fills the output buffer first: a
        fusion that XLA runs in place reads its operand there."""
        if name not in self.fns:
            objs = glob.glob(os.path.join(
                self.dumpdir, f"*obj-file.{name}_kernel_module.o"))
            if not objs:
                self.fns[name] = None
            else:
                so = os.path.join(self.workdir, f"{name}.so")
                subprocess.run(["gcc", "-shared", "-o", so, objs[0], "-lm"],
                               check=True, capture_output=True)
                fn = ctypes.CDLL(so)[name]
                fn.restype, fn.argtypes = ctypes.c_void_p, [
                    ctypes.POINTER(_Frame)]
                self.fns[name] = (fn, self._workgroups(
                    f"{name}_kernel_module"))
        if self.fns[name] is None:
            return None
        fn, count = self.fns[name]
        arrs = [np.ascontiguousarray(to_phys(np.asarray(a), parse_type(t)[2])
                                     .astype(DT[parse_type(t)[0]]))
                for a, t in inputs]
        dt, shape, layout = parse_type(out_type)
        out = np.zeros(int(np.prod(shape)), DT[dt])
        if init is not None:
            out[:] = to_phys(np.asarray(init), layout).astype(DT[dt])
        arrs.append(out)
        args = (_Arg * len(arrs))(*[_Arg(a.ctypes.data, a.nbytes)
                                    for a in arrs])
        n = _Dim(count, 1, 1)
        for x in range(count):
            w = _Dim(x, 0, 0)
            if fn(ctypes.byref(_Frame(ctypes.pointer(n), ctypes.pointer(w),
                                      len(arrs), args))):
                raise RuntimeError(f"{name}: kernel error")
        return from_phys(out, shape, layout)


def oracle_table(text: str, dumpdir: str, bear, pts):
    """Every f32 fusion of the program, the model's output against the
    compiled kernel's on the model's own inputs: (computation, fusion,
    bits equal, within 1e-3)."""
    rows = []
    with tempfile.TemporaryDirectory() as work:
        oracle = Oracle(dumpdir, work)
        it = Interp(text, lapack=lapack_call, gemv_dot=dot_mode)
        plain_eval = Interp.eval

        def eval_and_ask(self, ins, env, args, cname):
            val = plain_eval(self, ins, env, args, cname)
            if ins.op == "fusion" and ins.type.startswith("f32[") \
                    and not ins.type.startswith("f32[]"):
                types = {i.name: i.type for i in self.comps[cname]}
                got = oracle(ins.name, [(env[o], types[o])
                                        for o in ins.operands], ins.type)
                if got is not None:
                    v = np.asarray(val, np.float32)
                    same = (got.view(np.int32) == v.view(np.int32)) | (
                        np.isnan(got) & np.isnan(v))
                    rows.append((cname, ins.name, float(same.mean()),
                                 float(np.isclose(got, v, rtol=1e-3,
                                                  atol=1e-6,
                                                  equal_nan=True).mean())))
            return val

        it.eval = eval_and_ask.__get__(it)
        it.run(bear, pts)
    return rows


class _Stop(Exception):
    pass


def compiled_trace(text: str, dumpdir: str, bear, pts, until: str) -> dict:
    """The program's entry run op by op on ``bear`` and ``pts``, every f32
    fusion by XLA's own compiled kernel (its dumped object file; the
    model only where a fusion has none), up to the fusion ``until``: each
    fusion's and entry value's output by name (a loop's fusions: the last
    trip's). No interpreted fusion feeds the result, so it is the compiled
    reference's arithmetic as far as ``until``."""
    with tempfile.TemporaryDirectory() as work:
        oracle = Oracle(dumpdir, work)
        it = Interp(text, lapack=lapack_call, gemv_dot=dot_mode)
        plain_eval = Interp.eval
        out = {}

        def eval_compiled(self, ins, env, args, cname):
            if ins.op == "fusion" and ins.type.startswith("f32["):
                types = {i.name: i.type for i in self.comps[cname]}
                same = [o for o in ins.operands if types[o] == ins.type]
                got = oracle(ins.name, [(env[o], types[o])
                                        for o in ins.operands], ins.type,
                             init=env[same[0]] if same else None)
                val = got if got is not None else plain_eval(
                    self, ins, env, args, cname)
                out[ins.name] = val
                if ins.name == until:
                    raise _Stop
                return val
            return plain_eval(self, ins, env, args, cname)

        it.eval = eval_compiled.__get__(it)
        try:
            it.run(bear, pts)
        except _Stop:
            pass
    return {**it.trace, **out}


def ferrari_fusions(text: str) -> dict:
    """The fusions of the entry that hold Ferrari's roots (the concatenate
    of the four roots before ``- a / 4``) and the six polishes' ``f / fp``
    in order, by their roles: ``{"roots": name, "polishes": [names]}``
    (found by their operands: the polishes' chain starts at the roots)."""
    ops = {}
    for m in re.finditer(r"%(\S+) = f32\[(\d+),4\]\{1,0\} fusion\((.*?)\), "
                         r"kind=kLoop", text):
        ops[m.group(1)] = re.findall(r"%([\w.\-]+)", m.group(3))
    polishes = [n for n in ops if n.startswith("select_divide_fusion")]
    roots = [n for n in ops if n not in polishes]
    order = sorted(polishes, key=lambda n: sum(o in polishes
                                               for o in ops[n]))
    assert len(roots) == 1 and len(order) == 6, (roots, order)
    return {"roots": roots[0], "polishes": order}


# --- the P3P programs -----------------------------------------------------

def lapack_call(ins, A, it):
    """``lapack_sgetrf_ffi`` / ``lapack_strsm_ffi`` by the reading of
    tools/fit_lapack_order.py (ipiv 1-based, as LAPACK's)."""
    import fit_lapack_order as lo
    tgt = re.search(r'custom_call_target="(\w+)"', ins.attrs).group(1)
    if tgt == "lapack_sgetrf_ffi":
        M = np.asarray(A[0])
        sh, n = M.shape, M.shape[-1]
        lu, perm = lo.getf2(M.reshape(-1, n, n))
        ipiv = np.zeros((len(lu), n), np.int32)
        for b in range(len(lu)):
            p = list(range(n))
            for j in range(n):
                k = p.index(perm[b][j])
                ipiv[b, j] = k + 1
                p[j], p[k] = p[k], p[j]
        return (lu.reshape(sh), ipiv.reshape(sh[:-1]),
                np.zeros(sh[:-2], np.int32))
    if tgt == "lapack_strsm_ffi":
        uplo = int(re.search(r"uplo = (\d+)", ins.attrs).group(1))
        L, B = np.asarray(A[0]), np.asarray(A[1])
        n = L.shape[-1]
        x = lo.trsm(L.reshape(-1, n, n), B.reshape(-1, n), uplo == ord("L"))
        return x.reshape(B.shape)
    raise NotImplementedError(tgt)


def dot_mode(ins):
    """The emitted dot loops: the HIGHEST-precision einsum an FMA chain
    from +0, the small gemv calls unfused."""
    return "chain0" if "operand_precision" in ins.attrs else "unfused"


DUMP = """
import sys
sys.path.insert(0, sys.argv[1]); sys.path.insert(0, sys.argv[1] + '/tools')
import numpy as np, jax, jax.numpy as jnp
import fit_p3p_order as fit
from tod_tpu.geometry import pnp
b, p = fit.samples(int(sys.argv[2]), seed=3)
jax.jit(jax.vmap(pnp.p3p))(jnp.asarray(b), jnp.asarray(p))
"""

DUMP_2D = """
import sys, functools
sys.path.insert(0, sys.argv[1]); sys.path.insert(0, sys.argv[1] + '/tests')
import numpy as np, jax, jax.numpy as jnp
from tod_tpu.geometry import detection2d as rd
import test_torch_detection2d as t
obj, dist, valid, train, xy = t.scene()
jax.jit(functools.partial(rd.detect_frame_2d, max_matches=t.M,
                          cfg=rd.Pnp2dConfig(**t.CFG)))(
    jax.random.PRNGKey(t.SEED), obj, dist, valid, train, xy, t.K,
    jnp.arange(3))
rng = np.random.default_rng(0)
q, n_obj, m = 3000, 100, 128
obj = rng.integers(0, n_obj, (q, 2)).astype(np.int32)
jax.jit(functools.partial(rd.detect_frame_2d, max_matches=m,
                          cfg=rd.Pnp2dConfig(n_hypotheses=512, min_inliers=8,
                                             max_instances=2)))(
    jax.random.PRNGKey(0), obj, rng.uniform(0, 50, (q, 2)).astype(np.float32),
    np.ones((q, 2), bool), rng.uniform(-0.1, 0.1, (q, 2, 3)).astype(np.float32),
    rng.uniform(0, 640, (q, 2)).astype(np.float32), t.K,
    jnp.arange(n_obj))
"""


def dump(code: str, *argv) -> str:
    """Run ``code`` in a child that dumps XLA's artifacts; the dump's
    directory (a temporary one, removed at exit)."""
    tmp = tempfile.mkdtemp(prefix="p3p_fusions_")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"{os.environ.get('XLA_FLAGS', '')} "
                         f"--xla_dump_to={tmp}")
    subprocess.run([sys.executable, "-c", code, ROOT, *map(str, argv)],
                   env=env, check=True)
    return tmp


# the coefficient fusions' operands, by what the entry computes for them
COEF_ROOTS = ("C3/C4", "C2/C4", "C1/C4", "C0/C4")


def coefficient_fusions(text: str):
    """[(fusion name, called computation, operand names)] of the fusions
    whose root divides two polynomials in the cosines and side ratios:
    the normalised quartic coefficients, in the dump's order."""
    out = []
    for line in text.splitlines():
        m = re.match(r"\s*%(\S+) = f32\[\d+\]\{0\} fusion\((.*?)\), kind=kLoop, "
                     r"calls=%([\w.\-]+)", line)
        if not m:
            continue
        ops = re.findall(r"%([\w.\-]+)", m.group(2))
        if len(ops) in (4, 5) and all(o.startswith(("dot_general",
                                                    "multiply_divide"))
                                      for o in ops):
            out.append((m.group(1), m.group(3), ops))
    return out


def operand_names(text: str):
    """dot_general.* -> ca / cb / cg and multiply_divide_fusion.* -> Ar /
    Br, from the slices and norms that feed them."""
    names = {}
    slices = {}
    for name, comp in re.findall(r"%(slice_bitcast_fusion\S*) = .*?calls=%([\w.\-]+)", text):
        body = re.search(rf"%{re.escape(comp)} .*?\n(.*?)^\}}", text, re.S | re.M).group(1)
        slices[name] = int(re.search(r"slice=\{\[0:\d+\], \[(\d):", body).group(1))
    for name, a, b in re.findall(r"%(dot_general\.\d+) = f32\[\d+\]\{0\} dot\(%(\S+), %(\S+)\)", text):
        pair = sorted((slices[a], slices[b]))
        names[name] = {(1, 2): "ca", (0, 2): "cb", (0, 1): "cg"}[tuple(pair)]
    norms = {}
    for name, comp in re.findall(r"%(reduce_sqrt_fusion\.\d+) = f32\[\d+\]\{0\} fusion\(%points[^)]*\), kind=kLoop, calls=%([\w.\-]+)", text):
        body = re.search(rf"%{re.escape(comp)} .*?\n(.*?)^\}}", text, re.S | re.M).group(1)
        rows = sorted(int(r) for r in re.findall(r"slice=\{\[0:\d+\], \[(\d):", body))
        norms[name] = {(1, 2): "a", (0, 2): "b", (0, 1): "c"}[tuple(rows)]
    for name, x, y in re.findall(r"%(multiply_divide_fusion\.?\d*) = f32\[\d+\]\{0\} fusion\(%(\S+), %(\S+)\)", text):
        x, y = x.rstrip(","), y.rstrip(",")
        if norms.get(y) == "b":
            names[name] = {"a": "Ar", "c": "Br"}[norms[x]]
    return names


def canonical(expr: str) -> str:
    """``expr`` with its operand names replaced by v0, v1, ... in order of
    first appearance (programs name and number their operands apart)."""
    seen = {}

    def rename(m):
        return seen.setdefault(m.group(0), f"v{len(seen)}")
    return re.sub(r"[A-Za-z_][\w.\-]*(?=[,)\s*])", rename,
                  re.sub(r"\s+", " ", expr))


# the fusions from Ferrari's resolvent to the first distances (the port's
# pnp.ferrari_roots, polish_step and first distances), by their names in
# the standalone vmap(p3p) of jax 0.9.0
STAGE_FUSIONS = ("maximum_sqrt_fusion", "multiply_add_fusion",
                 "maximum_sqrt_fusion.1", "sqrt_atan2_fusion",
                 "broadcast_power_fusion", "abs_power_fusion",
                 "multiply_sqrt_fusion", "multiply_divide_fusion",
                 "bitcast_concatenate_fusion.5", "select_divide_fusion.5",
                 "sqrt_concatenate_fusion", "bitcast_concatenate_fusion.4")


def stage_fusions(text: str) -> dict:
    """{name: (called computation, operand names)} of ``STAGE_FUSIONS``
    in the standalone program."""
    out = {}
    for m in re.finditer(r"%(\S+) = [^\n]* fusion\(([^\n]*?)\), "
                         r"kind=kLoop, calls=%([\w.\-]+)", text):
        if m.group(1) in STAGE_FUSIONS:
            out[m.group(1)] = (m.group(3),
                               re.findall(r"%([\w.\-]+)", m.group(2)))
    return out


def big_fusions(text: str, min_muls: int = 8):
    """(fusion name, called computation, operands) of every fusion whose
    computation holds at least ``min_muls`` multiplies."""
    bodies = dict(re.findall(r"^%(\S+) [^\n]*\{\n(.*?)^\}", text, re.S | re.M))
    out = []
    for m in re.finditer(r"%(\S+) = [^\n]* fusion\(([^\n]*?)\), kind=kLoop, "
                         r"calls=%([\w.\-]+)", text):
        if len(re.findall(r" multiply\(", bodies.get(m.group(3), ""))) >= min_muls:
            out.append((m.group(1), m.group(3),
                        re.findall(r"%([\w.\-]+)", m.group(2))))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--samples", type=int, default=20000)
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--no-2d", action="store_true")
    ap.add_argument("--oracle", action="store_true",
                    help="call XLA's compiled fusions (the dumped object "
                    "files) on the model's inputs, fusion by fusion")
    args = ap.parse_args()
    import fit_p3p_order as fit
    import shutil

    ok = True
    n = args.samples
    tmp = dump(DUMP, n)
    try:
        text = open(glob.glob(os.path.join(
            tmp, "*jit_p3p.cpu_after_optimizations.txt"))[0]).read()
        if args.oracle:
            b, p = fit.samples(n, seed=3)
            print("fusion by fusion, the model against XLA's compiled kernel "
                  "on the same inputs (bits equal, within 1e-3):")
            for comp, name, eq, close in oracle_table(text, tmp, b, p):
                print(f"    {comp[:24]:<24} {name:<32} {eq:.4f} {close:.4f}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    it = Interp(text, lapack=lapack_call, gemv_dot=dot_mode)
    names = operand_names(text)
    fusions = coefficient_fusions(text)
    exprs = {}
    for fus, comp, ops in fusions:
        exprs[fus] = it.express(comp, [names.get(o, o) for o in ops])
    if args.list:
        for line in text.splitlines():
            m = re.match(r"\s*(?:ROOT )?%(\S+) = .* fusion\(.*calls=%([\w.\-]+)", line)
            if m:
                ops = re.findall(r"%([\w.\-]+)", line.split("fusion(")[1].split("), kind")[0])
                print(f"{m.group(1)} = {it.express(m.group(2), [names.get(o, o) for o in ops])}")
    # 1. the coefficients, interpreted, compiled and the port's
    bear, pts = fit.samples(n, seed=3)
    sides, want = fit.reference_stages(bear, pts)
    it.run(bear, pts)
    a, b, c, ca, cb, cg = (torch.from_numpy(np.array(x)) for x in sides)
    from tod_tpu_torch.geometry import pnp
    port = [x.numpy() for x in pnp.quartic_normalized(
        (a * a) / (b * b), (c * c) / (b * b), ca, cb, cg)]
    for fus, _, _ in fusions:
        got = it.trace[fus]
        k = [int((got.view(np.int32) == w.view(np.int32)).sum()) for w in want]
        which = int(np.argmax(k))
        hit_port = int((port[which].view(np.int32)
                        == want[which].view(np.int32)).sum())
        print(f"{COEF_ROOTS[which]} ({fus}) = {exprs[fus]}")
        print(f"    interpreted = compiled {k[which]} of {n}; "
              f"pnp.quartic_normalized = compiled {hit_port} of {n}")
        ok &= k[which] == n and hit_port == n
    # 2. the 2D path's programs
    if not args.no_2d:
        tmp = dump(DUMP_2D)
        try:
            for path in sorted(glob.glob(os.path.join(
                    tmp, "*.cpu_after_optimizations.txt"))):
                t2 = open(path).read()
                if "lapack_sgetrf_ffi" not in t2:    # not a 2D path program
                    continue
                it2 = Interp(t2)
                found = {canonical(it2.express(comp, ops))
                         for _, comp, ops in big_fusions(t2)}
                mine = {canonical(it.express(comp, ops))
                        for _, comp, ops in fusions}
                later = {canonical(it.express(comp, ops))
                         for comp, ops in stage_fusions(text).values()}
                found |= {canonical(it2.express(comp, ops))
                          for _, comp, ops in big_fusions(t2, 0)}
                print(f"2D path program {os.path.basename(path).split('.cpu_')[0]}: "
                      f"{len(mine & found)} of the 4 coefficient fusions and "
                      f"{len(later & found)} of the {len(later)} fusions of "
                      f"Ferrari's solution, the polishes and the first "
                      f"distances contracted as in the standalone vmap(p3p)")
                ok &= mine <= found and later <= found
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    # 3. the later stages against partial programs of the same code
    print("later stages (the interpreter's model against the compiled "
          "program's own outputs):")
    R, T, V = (it.trace[k] for k in ("broadcast_select_fusion.1",
                                     "multiply_subtract_fusion",
                                     "and_and_fusion"))
    import jax
    import jax.numpy as jnp
    from tod_tpu.geometry import pnp as rp
    ref = jax.jit(jax.vmap(rp.p3p))(jnp.asarray(bear), jnp.asarray(pts))
    eq = lambda x, y: ((np.asarray(x).view(np.int32) == np.asarray(y).view(np.int32))
                       | (np.isnan(x) & np.isnan(y)))
    print(f"    valid {float((V == np.asarray(ref.valid)).mean()):.4f}, "
          f"T {float(eq(T, ref.T).all(-1).mean()):.4f}, "
          f"R {float(eq(R, ref.R).all((-1, -2)).mean()):.4f} of the "
          f"candidates bit for bit")
    print("coefficients hold" if ok else "COEFFICIENTS MISS BITS")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
