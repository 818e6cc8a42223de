"""A batched IEC 61131-3 Structured Text interpreter for the emitted subset.

This is the *verification half* of the ST export backend: every
``FUNCTION_BLOCK`` that ``repro_torch.codegen.st`` emits is parsed and executed
here, in-suite, against the §6.1 oracle — the emulator is the test harness
that turns "the exporter looks right" into "the exported arithmetic IS the
served arithmetic" (bit-exact for SINT, epsilon for REAL).  It therefore
implements the PLC-relevant semantics precisely rather than conveniently:

* **Strong typing.**  REAL is IEEE-754 binary32 with one rounding per
  operation; SINT/INT/DINT are int8/int16/int32.  There are NO implicit
  conversions: ``REAL + DINT`` is a compile-time :class:`STTypeError`, and
  mixed-width integer arithmetic must go through the explicit
  ``<SRC>_TO_<DST>`` conversion functions, exactly as a strict 61131-3
  compiler enforces.  Untyped integer literals adapt to the concrete type
  they meet (``ACC := 0`` is a DINT zero when ``ACC`` is DINT), with
  compile-time range checks.
* **Integer semantics.**  Arithmetic wraps two's-complement at the declared
  width; division truncates toward zero and traps on a zero divisor; ``MOD``
  takes the dividend's sign (so ``a = (a / b) * b + (a MOD b)`` holds).
* **Conversions.**  ``REAL_TO_SINT/INT/DINT`` round half-to-even (the
  61131-3 / IEC 60559 convention — identical to ``numpy.rint``), and trap on
  non-finite or out-of-range values; narrowing integer conversions trap out
  of range; ``TRUNC`` truncates toward zero to DINT.
* **FB state.**  ``VAR`` (and ``VAR_OUTPUT``) values persist across
  :meth:`STFunctionBlock.call` invocations, like a real function block
  instance; :meth:`STFunctionBlock.reset` re-runs the declaration
  initializers.  ``VAR CONSTANT`` is write-protected at compile time.

**Batched execution.**  Replaying a full scenario run means evaluating the
same block over hundreds of windows, so the interpreter is *vectorized over
a window batch*: every runtime scalar is either a numpy scalar or a ``(B,)``
lane vector, ``IF``/``ELSIF``/``ELSE`` with batch-varying conditions run
both branches under complementary lane masks (assignments are
``np.where``-predicated), and one interpreted pass serves the whole batch.
Two restrictions follow (both hold for all emitted code, and both trap with
a clear error rather than silently mis-executing): array indices and ``FOR``
bounds must be batch-uniform, and a ``FOR`` counter is shared across lanes
(IEC leaves the counter undefined after the loop, so masking it is not
observable in conforming code).

Supported subset (everything ``codegen/st.py`` emits, plus enough slack for
hand-written test programs): one ``FUNCTION_BLOCK`` per source;
``VAR_INPUT`` / ``VAR_OUTPUT`` / ``VAR`` / ``VAR CONSTANT`` declarations of
REAL/SINT/INT/DINT/BOOL scalars and 1-D arrays with literal initializers;
assignment, ``IF/ELSIF/ELSE``, ``FOR .. TO .. BY``; arithmetic, comparison
and boolean operators; ``MAX/MIN/ABS/EXP/SQRT/LN/TRUNC`` and the
``<SRC>_TO_<DST>`` conversion family; ``(* ... *)`` comments.
"""

from __future__ import annotations

import re
import warnings
from typing import Dict, List, Optional, Tuple

import numpy as np


class STError(Exception):
    """Base for everything the emulator raises about an ST program."""


class STSyntaxError(STError):
    pass


class STTypeError(STError):
    pass


class STRuntimeError(STError):
    pass


SCALAR_TYPES = ("REAL", "SINT", "INT", "DINT", "BOOL")
INT_TYPES = ("SINT", "INT", "DINT")
DTYPES = {
    "REAL": np.float32,
    "SINT": np.int8,
    "INT": np.int16,
    "DINT": np.int32,
    "BOOL": np.bool_,
}
INT_RANGES = {
    t: (int(np.iinfo(DTYPES[t]).min), int(np.iinfo(DTYPES[t]).max))
    for t in INT_TYPES
}
_ANYINT = "ANYINT"          # untyped integer literal, adapts to context
_INT_WIDTH = {"SINT": 8, "INT": 16, "DINT": 32}

KEYWORDS = {
    "FUNCTION_BLOCK", "END_FUNCTION_BLOCK", "VAR_INPUT", "VAR_OUTPUT",
    "VAR", "CONSTANT", "END_VAR", "ARRAY", "OF", "IF", "THEN", "ELSIF",
    "ELSE", "END_IF", "FOR", "TO", "BY", "DO", "END_FOR", "AND", "OR",
    "XOR", "NOT", "MOD", "TRUE", "FALSE",
} | set(SCALAR_TYPES)


# ---------------------------------------------------------------------------
# Tokenizer
# ---------------------------------------------------------------------------

_TOKEN_RE = re.compile(
    r"""(?P<ws>\s+)
      | (?P<comment>\(\*.*?\*\))
      | (?P<real>\d+\.\d+(?:[eE][+-]?\d+)?|\d+[eE][+-]?\d+)
      | (?P<int>\d+)
      | (?P<id>[A-Za-z_][A-Za-z0-9_]*)
      | (?P<op>:=|\.\.|<=|>=|<>|[][(),;:+\-*/<>=])
    """,
    re.VERBOSE | re.DOTALL,
)


def tokenize(text: str) -> List[Tuple[str, object, int]]:
    """``(kind, value, line)`` tokens; kinds: id / int / real / op / eof.
    Identifiers are case-normalized to upper (IEC identifiers are
    case-insensitive); ``(* ... *)`` comments and whitespace are dropped."""
    toks: List[Tuple[str, object, int]] = []
    pos, line = 0, 1
    n = len(text)
    while pos < n:
        m = _TOKEN_RE.match(text, pos)
        if m is None:
            raise STSyntaxError(
                f"line {line}: unexpected character {text[pos]!r}")
        kind = m.lastgroup
        tok = m.group()
        if kind == "id":
            toks.append(("id", tok.upper(), line))
        elif kind == "int":
            toks.append(("int", int(tok), line))
        elif kind == "real":
            toks.append(("real", float(tok), line))
        elif kind == "op":
            toks.append(("op", tok, line))
        # ws / comment: dropped (but still advance the line counter)
        line += tok.count("\n")
        pos = m.end()
    toks.append(("eof", None, line))
    return toks


# ---------------------------------------------------------------------------
# AST
# ---------------------------------------------------------------------------


class _Node:
    __slots__ = ("line",)

    def __init__(self, line):
        self.line = line


class _Lit(_Node):
    __slots__ = ("value", "kind")        # kind: ANYINT / REAL / BOOL

    def __init__(self, line, value, kind):
        super().__init__(line)
        self.value = value
        self.kind = kind


class _Var(_Node):
    __slots__ = ("name",)

    def __init__(self, line, name):
        super().__init__(line)
        self.name = name


class _Index(_Node):
    __slots__ = ("name", "idx")

    def __init__(self, line, name, idx):
        super().__init__(line)
        self.name = name
        self.idx = idx


class _Unary(_Node):
    __slots__ = ("op", "e")

    def __init__(self, line, op, e):
        super().__init__(line)
        self.op = op
        self.e = e


class _Bin(_Node):
    __slots__ = ("op", "a", "b")

    def __init__(self, line, op, a, b):
        super().__init__(line)
        self.op = op
        self.a = a
        self.b = b


class _Call(_Node):
    __slots__ = ("fn", "args")

    def __init__(self, line, fn, args):
        super().__init__(line)
        self.fn = fn
        self.args = args


class _Assign(_Node):
    __slots__ = ("target", "expr")

    def __init__(self, line, target, expr):
        super().__init__(line)
        self.target = target
        self.expr = expr


class _If(_Node):
    __slots__ = ("arms", "orelse")       # arms: [(cond, [stmt])]

    def __init__(self, line, arms, orelse):
        super().__init__(line)
        self.arms = arms
        self.orelse = orelse


class _For(_Node):
    __slots__ = ("var", "start", "stop", "step", "body")

    def __init__(self, line, var, start, stop, step, body):
        super().__init__(line)
        self.var = var
        self.start = start
        self.stop = stop
        self.step = step
        self.body = body


class _Decl:
    __slots__ = ("name", "base", "lo", "hi", "section", "const", "init",
                 "line")

    def __init__(self, name, base, lo, hi, section, const, init, line):
        self.name = name
        self.base = base          # scalar type name
        self.lo = lo              # None for scalars
        self.hi = hi
        self.section = section    # VAR_INPUT / VAR_OUTPUT / VAR
        self.const = const
        self.init = init          # scalar literal | list | None
        self.line = line

    @property
    def is_array(self) -> bool:
        return self.lo is not None

    @property
    def size(self) -> int:
        return self.hi - self.lo + 1


# ---------------------------------------------------------------------------
# Parser
# ---------------------------------------------------------------------------


class _Parser:
    def __init__(self, toks):
        self.toks = toks
        self.i = 0

    def peek(self):
        return self.toks[self.i]

    def next(self):
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect(self, kind, value=None):
        k, v, line = self.next()
        if k != kind or (value is not None and v != value):
            want = value if value is not None else kind
            raise STSyntaxError(f"line {line}: expected {want!r}, got {v!r}")
        return v, line

    def at(self, kind, value=None):
        k, v, _ = self.peek()
        return k == kind and (value is None or v == value)

    # -- program ------------------------------------------------------------

    def parse_function_block(self):
        self.expect("id", "FUNCTION_BLOCK")
        name, _ = self.expect("id")
        if name in KEYWORDS:
            raise STSyntaxError(f"FUNCTION_BLOCK name {name!r} is a keyword")
        decls: Dict[str, _Decl] = {}
        order: List[str] = []
        while self.at("id", "VAR_INPUT") or self.at("id", "VAR_OUTPUT") or \
                self.at("id", "VAR"):
            section, line = self.expect("id")
            const = False
            if section == "VAR" and self.at("id", "CONSTANT"):
                self.next()
                const = True
            while not self.at("id", "END_VAR"):
                d = self.parse_decl(section, const)
                if d.name in decls:
                    raise STSyntaxError(
                        f"line {d.line}: duplicate declaration of {d.name}")
                decls[d.name] = d
                order.append(d.name)
            self.expect("id", "END_VAR")
        stmts = self.parse_statements(("END_FUNCTION_BLOCK",))
        self.expect("id", "END_FUNCTION_BLOCK")
        if not self.at("eof"):
            _, v, line = self.peek()
            raise STSyntaxError(
                f"line {line}: trailing content after END_FUNCTION_BLOCK")
        return name, decls, order, stmts

    def parse_decl(self, section, const):
        name, line = self.expect("id")
        if name in KEYWORDS:
            raise STSyntaxError(f"line {line}: {name!r} is a keyword")
        self.expect("op", ":")
        lo = hi = None
        if self.at("id", "ARRAY"):
            self.next()
            self.expect("op", "[")
            lo = self.parse_int_bound()
            self.expect("op", "..")
            hi = self.parse_int_bound()
            self.expect("op", "]")
            self.expect("id", "OF")
            if hi < lo:
                raise STSyntaxError(
                    f"line {line}: array bounds [{lo}..{hi}] are empty")
        base, _ = self.expect("id")
        if base not in SCALAR_TYPES:
            raise STSyntaxError(f"line {line}: unsupported type {base!r}")
        init = None
        if self.at("op", ":="):
            self.next()
            if lo is not None:
                self.expect("op", "[")
                init = []
                while True:
                    init.append(self.parse_literal())
                    if self.at("op", ","):
                        self.next()
                        continue
                    break
                self.expect("op", "]")
                if len(init) != hi - lo + 1:
                    raise STSyntaxError(
                        f"line {line}: {name} initializer has {len(init)} "
                        f"elements for ARRAY[{lo}..{hi}]")
            else:
                init = self.parse_literal()
        self.expect("op", ";")
        return _Decl(name, base, lo, hi, section, const, init, line)

    def parse_int_bound(self):
        neg = False
        if self.at("op", "-"):
            self.next()
            neg = True
        v, _ = self.expect("int")
        return -v if neg else v

    def parse_literal(self):
        """A (possibly signed) numeric or boolean literal — initializers
        only, parsed to raw python values for speed (weight arrays are
        tens of thousands of elements)."""
        neg = False
        if self.at("op", "-"):
            self.next()
            neg = True
        k, v, line = self.next()
        if k == "int" or k == "real":
            return -v if neg else v
        if k == "id" and v in ("TRUE", "FALSE") and not neg:
            return v == "TRUE"
        raise STSyntaxError(f"line {line}: expected a literal, got {v!r}")

    # -- statements ---------------------------------------------------------

    def parse_statements(self, stop_keywords):
        out = []
        while True:
            k, v, _ = self.peek()
            if k == "eof" or (k == "id" and v in stop_keywords):
                return out
            out.append(self.parse_statement())

    def parse_statement(self):
        k, v, line = self.peek()
        if k == "id" and v == "IF":
            return self.parse_if()
        if k == "id" and v == "FOR":
            return self.parse_for()
        # assignment
        target = self.parse_primary()
        if not isinstance(target, (_Var, _Index)):
            raise STSyntaxError(
                f"line {line}: statement must be an assignment")
        self.expect("op", ":=")
        expr = self.parse_expr()
        self.expect("op", ";")
        return _Assign(line, target, expr)

    def parse_if(self):
        _, line = self.expect("id", "IF")
        arms = []
        cond = self.parse_expr()
        self.expect("id", "THEN")
        arms.append((cond, self.parse_statements(
            ("ELSIF", "ELSE", "END_IF"))))
        while self.at("id", "ELSIF"):
            self.next()
            cond = self.parse_expr()
            self.expect("id", "THEN")
            arms.append((cond, self.parse_statements(
                ("ELSIF", "ELSE", "END_IF"))))
        orelse = []
        if self.at("id", "ELSE"):
            self.next()
            orelse = self.parse_statements(("END_IF",))
        self.expect("id", "END_IF")
        self.expect("op", ";")
        return _If(line, arms, orelse)

    def parse_for(self):
        _, line = self.expect("id", "FOR")
        var, _ = self.expect("id")
        self.expect("op", ":=")
        start = self.parse_expr()
        self.expect("id", "TO")
        stop = self.parse_expr()
        step = None
        if self.at("id", "BY"):
            self.next()
            step = self.parse_expr()
        self.expect("id", "DO")
        body = self.parse_statements(("END_FOR",))
        self.expect("id", "END_FOR")
        self.expect("op", ";")
        return _For(line, var, start, stop, step, body)

    # -- expressions (precedence climbing) ----------------------------------

    def parse_expr(self):
        return self.parse_or()

    def parse_or(self):
        e = self.parse_xor()
        while self.at("id", "OR"):
            _, _, line = self.next()
            e = _Bin(line, "OR", e, self.parse_xor())
        return e

    def parse_xor(self):
        e = self.parse_and()
        while self.at("id", "XOR"):
            _, _, line = self.next()
            e = _Bin(line, "XOR", e, self.parse_and())
        return e

    def parse_and(self):
        e = self.parse_cmp()
        while self.at("id", "AND"):
            _, _, line = self.next()
            e = _Bin(line, "AND", e, self.parse_cmp())
        return e

    def parse_cmp(self):
        e = self.parse_add()
        k, v, line = self.peek()
        if k == "op" and v in ("=", "<>", "<", ">", "<=", ">="):
            self.next()
            return _Bin(line, v, e, self.parse_add())
        return e

    def parse_add(self):
        e = self.parse_mul()
        while True:
            k, v, line = self.peek()
            if k == "op" and v in ("+", "-"):
                self.next()
                e = _Bin(line, v, e, self.parse_mul())
            else:
                return e

    def parse_mul(self):
        e = self.parse_unary()
        while True:
            k, v, line = self.peek()
            if (k == "op" and v in ("*", "/")) or (k == "id" and v == "MOD"):
                self.next()
                e = _Bin(line, "MOD" if v == "MOD" else v, e,
                         self.parse_unary())
            else:
                return e

    def parse_unary(self):
        k, v, line = self.peek()
        if k == "op" and v in ("-", "+"):
            self.next()
            e = self.parse_unary()
            return e if v == "+" else _Unary(line, "-", e)
        if k == "id" and v == "NOT":
            self.next()
            return _Unary(line, "NOT", self.parse_unary())
        return self.parse_primary()

    def parse_primary(self):
        k, v, line = self.next()
        if k == "int":
            return _Lit(line, v, _ANYINT)
        if k == "real":
            return _Lit(line, v, "REAL")
        if k == "op" and v == "(":
            e = self.parse_expr()
            self.expect("op", ")")
            return e
        if k == "id":
            if v == "TRUE":
                return _Lit(line, True, "BOOL")
            if v == "FALSE":
                return _Lit(line, False, "BOOL")
            if v in KEYWORDS:
                raise STSyntaxError(
                    f"line {line}: unexpected keyword {v!r} in expression")
            if self.at("op", "("):
                self.next()
                args = []
                if not self.at("op", ")"):
                    while True:
                        args.append(self.parse_expr())
                        if self.at("op", ","):
                            self.next()
                            continue
                        break
                self.expect("op", ")")
                return _Call(line, v, args)
            if self.at("op", "["):
                self.next()
                idx = self.parse_expr()
                self.expect("op", "]")
                return _Index(line, v, idx)
            return _Var(line, v)
        raise STSyntaxError(f"line {line}: unexpected token {v!r}")


# ---------------------------------------------------------------------------
# Runtime helpers
# ---------------------------------------------------------------------------


class _Frame:
    __slots__ = ("vars", "mask", "batch")

    def __init__(self, vars, batch):
        self.vars = vars
        self.mask = None          # None = all lanes active
        self.batch = batch


def _uniform_int(v, line, what):
    """Array indices / loop bounds must be one value across the batch."""
    if isinstance(v, np.ndarray) and v.ndim:
        first = v.flat[0]
        if not (v == first).all():
            raise STRuntimeError(
                f"line {line}: batch-varying {what} is outside the emulated "
                "subset (all lanes must agree)")
        return int(first)
    return int(v)


def _check_active(bad, mask, line, msg):
    """Trap only if a *live* lane violates; masked-off lanes may hold
    garbage (their results are discarded by the predication)."""
    if mask is not None:
        bad = np.logical_and(bad, mask)
    if np.any(bad):
        raise STRuntimeError(f"line {line}: {msg}")


def _wrap_int(v, base):
    """Two's-complement wrap of a python int into an ST integer type."""
    width = _INT_WIDTH[base]
    v &= (1 << width) - 1
    if v >= 1 << (width - 1):
        v -= 1 << width
    return DTYPES[base](v)


def _store(frame, old, new):
    if frame.mask is None:
        return new
    return np.where(frame.mask, new, old)


# ---------------------------------------------------------------------------
# Compiler: typed AST -> closures over a _Frame
# ---------------------------------------------------------------------------


class _Compiler:
    def __init__(self, decls: Dict[str, _Decl]):
        self.decls = decls

    # -- type plumbing ------------------------------------------------------

    def _decl(self, name, line):
        d = self.decls.get(name)
        if d is None:
            raise STTypeError(f"line {line}: undeclared variable {name}")
        return d

    def _unify(self, ta, tb, line, what):
        """The common type of two operand types under strict IEC typing:
        identical types unify; an untyped integer literal adapts to any
        integer type; everything else is a compile-time error."""
        if ta == tb:
            return ta
        if ta == _ANYINT and tb in INT_TYPES:
            return tb
        if tb == _ANYINT and ta in INT_TYPES:
            return ta
        raise STTypeError(
            f"line {line}: {what} needs matching types, got {ta} and {tb} "
            "(IEC 61131-3 has no implicit conversions; use "
            "<SRC>_TO_<DST>)")

    def _coerce(self, t_from, fn, t_to, line):
        """Adapt an ANYINT closure to a concrete integer type (range-checked
        at runtime; literals are constant so this fires at first use)."""
        if t_from == t_to:
            return fn
        assert t_from == _ANYINT and t_to in INT_TYPES
        lo, hi = INT_RANGES[t_to]
        dtype = DTYPES[t_to]

        def run(fr):
            v = fn(fr)
            if not lo <= v <= hi:
                raise STRuntimeError(
                    f"line {line}: literal {v} out of {t_to} range "
                    f"[{lo}, {hi}]")
            return dtype(v)

        return run

    # -- expressions --------------------------------------------------------

    def expr(self, node):
        """Compile an expression to ``(type, fn)``; ``fn(frame)`` returns a
        numpy scalar / (B,) vector (or a python int for ANYINT)."""
        if isinstance(node, _Lit):
            if node.kind == "REAL":
                v = np.float32(node.value)
                return "REAL", lambda fr: v
            if node.kind == "BOOL":
                v = np.bool_(node.value)
                return "BOOL", lambda fr: v
            v = node.value
            return _ANYINT, lambda fr: v
        if isinstance(node, _Var):
            d = self._decl(node.name, node.line)
            if d.is_array:
                raise STTypeError(
                    f"line {node.line}: {node.name} is an array; index it")
            name = node.name
            return d.base, lambda fr: fr.vars[name]
        if isinstance(node, _Index):
            return self._index_read(node)
        if isinstance(node, _Unary):
            return self._unary(node)
        if isinstance(node, _Bin):
            return self._binary(node)
        if isinstance(node, _Call):
            return self._call(node)
        raise STSyntaxError(f"line {node.line}: unsupported expression")

    def _index_read(self, node):
        d = self._decl(node.name, node.line)
        if not d.is_array:
            raise STTypeError(f"line {node.line}: {node.name} is not an array")
        ti, fi = self.expr(node.idx)
        if ti not in INT_TYPES and ti != _ANYINT:
            raise STTypeError(
                f"line {node.line}: array index must be an integer, got {ti}")
        name, lo, size, line = node.name, d.lo, d.size, node.line

        def run(fr):
            i = _uniform_int(fi(fr), line, "array index") - lo
            if not 0 <= i < size:
                raise STRuntimeError(
                    f"line {line}: index {i + lo} out of bounds for "
                    f"{name}[{lo}..{lo + size - 1}]")
            return fr.vars[name][i]

        return d.base, run

    def _unary(self, node):
        t, f = self.expr(node.e)
        if node.op == "NOT":
            if t != "BOOL":
                raise STTypeError(
                    f"line {node.line}: NOT needs BOOL, got {t}")
            return "BOOL", lambda fr: np.logical_not(f(fr))
        # negation
        if t == _ANYINT:
            return _ANYINT, lambda fr: -f(fr)
        if t == "REAL":
            return "REAL", lambda fr: -f(fr)
        if t in INT_TYPES:
            base = t
            return t, lambda fr: -f(fr) if isinstance(f(fr), np.ndarray) \
                else _neg_scalar(f(fr), base)
        raise STTypeError(f"line {node.line}: cannot negate {t}")

    def _binary(self, node):
        op = node.op
        ta, fa = self.expr(node.a)
        tb, fb = self.expr(node.b)
        line = node.line
        if op in ("AND", "OR", "XOR"):
            if ta != "BOOL" or tb != "BOOL":
                raise STTypeError(
                    f"line {line}: {op} needs BOOL operands, got "
                    f"{ta} and {tb}")
            npf = {"AND": np.logical_and, "OR": np.logical_or,
                   "XOR": np.logical_xor}[op]
            return "BOOL", lambda fr: npf(fa(fr), fb(fr))
        if op in ("=", "<>", "<", ">", "<=", ">="):
            t = self._unify(ta, tb, line, f"comparison {op!r}")
            if t == "BOOL" and op not in ("=", "<>"):
                raise STTypeError(
                    f"line {line}: BOOL only supports = and <>")
            fa = self._coerce(ta, fa, t, line) if ta != t else fa
            fb = self._coerce(tb, fb, t, line) if tb != t else fb
            npf = {"=": np.equal, "<>": np.not_equal, "<": np.less,
                   ">": np.greater, "<=": np.less_equal,
                   ">=": np.greater_equal}[op]
            return "BOOL", lambda fr: npf(fa(fr), fb(fr))
        # arithmetic
        t = self._unify(ta, tb, line, f"operator {op!r}")
        if t == "BOOL":
            raise STTypeError(f"line {line}: no arithmetic on BOOL")
        if t == _ANYINT:
            return _ANYINT, self._anyint_arith(op, fa, fb, line)
        fa = self._coerce(ta, fa, t, line) if ta != t else fa
        fb = self._coerce(tb, fb, t, line) if tb != t else fb
        if op == "+":
            return t, lambda fr: fa(fr) + fb(fr)
        if op == "-":
            return t, lambda fr: fa(fr) - fb(fr)
        if op == "*":
            return t, lambda fr: fa(fr) * fb(fr)
        if op == "MOD":
            if t == "REAL":
                raise STTypeError(
                    f"line {line}: MOD is integer-only in IEC 61131-3")
            return t, _int_divmod(fa, fb, line, want_mod=True)
        if op == "/":
            if t == "REAL":
                return t, lambda fr: fa(fr) / fb(fr)
            return t, _int_divmod(fa, fb, line, want_mod=False)
        raise STSyntaxError(f"line {line}: unknown operator {op!r}")

    @staticmethod
    def _anyint_arith(op, fa, fb, line):
        def run(fr):
            a, b = fa(fr), fb(fr)
            if op == "+":
                return a + b
            if op == "-":
                return a - b
            if op == "*":
                return a * b
            if b == 0:
                raise STRuntimeError(f"line {line}: division by zero")
            q = abs(a) // abs(b) * (1 if (a < 0) == (b < 0) else -1)
            return q if op == "/" else a - q * b

        return run

    # -- calls --------------------------------------------------------------

    _CONV_RE = re.compile(r"^(REAL|SINT|INT|DINT)_TO_(REAL|SINT|INT|DINT)$")

    def _call(self, node):
        name, line = node.fn, node.line
        m = self._CONV_RE.match(name)
        if m:
            if len(node.args) != 1:
                raise STTypeError(f"line {line}: {name} takes one argument")
            return self._conversion(m.group(1), m.group(2), node.args[0],
                                    line)
        if name in ("MAX", "MIN"):
            if len(node.args) != 2:
                raise STTypeError(f"line {line}: {name} takes two arguments")
            ta, fa = self.expr(node.args[0])
            tb, fb = self.expr(node.args[1])
            t = self._unify(ta, tb, line, name)
            if t == "BOOL":
                raise STTypeError(f"line {line}: {name} is numeric")
            if t == _ANYINT:
                t = "DINT"
            fa = self._coerce(ta, fa, t, line) if ta != t else fa
            fb = self._coerce(tb, fb, t, line) if tb != t else fb
            npf = np.maximum if name == "MAX" else np.minimum
            return t, lambda fr: npf(fa(fr), fb(fr))
        if name == "ABS":
            (t, f), = [self.expr(a) for a in node.args[:1]]
            if len(node.args) != 1 or t == "BOOL":
                raise STTypeError(f"line {line}: ABS takes one numeric arg")
            if t == _ANYINT:
                return _ANYINT, lambda fr: abs(f(fr))
            return t, lambda fr: np.abs(f(fr))
        if name in ("EXP", "SQRT", "LN"):
            if len(node.args) != 1:
                raise STTypeError(f"line {line}: {name} takes one argument")
            t, f = self.expr(node.args[0])
            if t != "REAL":
                raise STTypeError(f"line {line}: {name} needs REAL, got {t}")
            npf = {"EXP": np.exp, "SQRT": np.sqrt, "LN": np.log}[name]
            return "REAL", lambda fr: npf(f(fr))
        if name == "TRUNC":
            if len(node.args) != 1:
                raise STTypeError(f"line {line}: TRUNC takes one argument")
            t, f = self.expr(node.args[0])
            if t != "REAL":
                raise STTypeError(f"line {line}: TRUNC needs REAL, got {t}")
            return "DINT", _real_to_int(f, "DINT", line, rounder=np.trunc)
        raise STTypeError(f"line {line}: unknown function {name}")

    def _conversion(self, src, dst, arg, line):
        t, f = self.expr(arg)
        if t == _ANYINT and src in INT_TYPES:
            f = self._coerce(t, f, src, line)
        elif t != src:
            raise STTypeError(
                f"line {line}: {src}_TO_{dst} applied to {t} value")
        if src == dst:
            return dst, f
        if dst == "REAL":                       # int -> REAL: exactness up
            return "REAL", lambda fr: _cast(f(fr), np.float32)
        if src == "REAL":                       # REAL -> int: round half-even
            return dst, _real_to_int(f, dst, line, rounder=np.rint)
        # int -> int
        lo_d, hi_d = INT_RANGES[dst]
        lo_s, hi_s = INT_RANGES[src]
        dtype = DTYPES[dst]
        if lo_d <= lo_s and hi_s <= hi_d:       # widening: always exact
            return dst, lambda fr: _cast(f(fr), dtype)

        def run(fr):                            # narrowing: trap out of range
            v = f(fr)
            _check_active((v < lo_d) | (v > hi_d), fr.mask, line,
                          f"{src}_TO_{dst} value out of {dst} range")
            return _cast(np.clip(v, lo_d, hi_d), dtype)

        return dst, run

    # -- statements ---------------------------------------------------------

    def statements(self, stmts):
        return [self.statement(s) for s in stmts]

    def statement(self, node):
        if isinstance(node, _Assign):
            return self._assign(node)
        if isinstance(node, _If):
            return self._if(node)
        if isinstance(node, _For):
            return self._for(node)
        raise STSyntaxError(f"line {node.line}: unsupported statement")

    def _check_writable(self, d, line):
        if d.const:
            raise STTypeError(
                f"line {line}: {d.name} is VAR CONSTANT and cannot be "
                "assigned")

    def _value_for(self, d, expr, line):
        t, f = self.expr(expr)
        if t == d.base:
            return f
        if t == _ANYINT and d.base in INT_TYPES:
            return self._coerce(t, f, d.base, line)
        raise STTypeError(
            f"line {line}: cannot assign {t} to {d.name} ({d.base})")

    def _assign(self, node):
        line = node.line
        if isinstance(node.target, _Var):
            d = self._decl(node.target.name, line)
            if d.is_array:
                raise STTypeError(
                    f"line {line}: whole-array assignment is outside the "
                    "emulated subset")
            self._check_writable(d, line)
            f = self._value_for(d, node.expr, line)
            name = d.name

            def run(fr):
                fr.vars[name] = _store(fr, fr.vars[name], f(fr))

            return run
        d = self._decl(node.target.name, line)
        if not d.is_array:
            raise STTypeError(f"line {line}: {d.name} is not an array")
        self._check_writable(d, line)
        ti, fi = self.expr(node.target.idx)
        if ti not in INT_TYPES and ti != _ANYINT:
            raise STTypeError(
                f"line {line}: array index must be an integer, got {ti}")
        f = self._value_for(d, node.expr, line)
        name, lo, size = d.name, d.lo, d.size

        def run(fr):
            i = _uniform_int(fi(fr), line, "array index") - lo
            if not 0 <= i < size:
                raise STRuntimeError(
                    f"line {line}: index {i + lo} out of bounds for "
                    f"{name}[{lo}..{lo + size - 1}]")
            arr = fr.vars[name]
            arr[i] = _store(fr, arr[i], f(fr))

        return run

    def _if(self, node):
        arms = [(self._bool_cond(c, node.line), self.statements(b))
                for c, b in node.arms]
        orelse = self.statements(node.orelse)

        def run(fr):
            outer = fr.mask
            rem = outer                   # lanes still looking for a branch
            try:
                for cond, body in arms:
                    fr.mask = rem
                    c = cond(fr)
                    if not (isinstance(c, np.ndarray) and c.ndim):
                        if bool(c):       # batch-uniform condition: fast path
                            fr.mask = rem
                            for s in body:
                                s(fr)
                            return
                        continue
                    take = c if rem is None else np.logical_and(rem, c)
                    if take.any():
                        fr.mask = take
                        for s in body:
                            s(fr)
                    rem = np.logical_and(rem, np.logical_not(c)) \
                        if rem is not None else np.logical_not(c)
                    if not rem.any():
                        return
                if orelse and (rem is None or not isinstance(rem, np.ndarray)
                               or rem.any()):
                    fr.mask = rem
                    for s in orelse:
                        s(fr)
            finally:
                fr.mask = outer

        return run

    def _bool_cond(self, cond, line):
        t, f = self.expr(cond)
        if t != "BOOL":
            raise STTypeError(
                f"line {line}: IF condition must be BOOL, got {t}")
        return f

    def _for(self, node):
        d = self._decl(node.var, node.line)
        if d.is_array or d.base not in INT_TYPES:
            raise STTypeError(
                f"line {node.line}: FOR counter {node.var} must be an "
                "integer scalar")
        self._check_writable(d, node.line)
        bounds = []
        for what, e in (("start", node.start), ("stop", node.stop),
                        ("step", node.step)):
            if e is None:
                bounds.append(None)
                continue
            t, f = self.expr(e)
            if t not in INT_TYPES and t != _ANYINT:
                raise STTypeError(
                    f"line {node.line}: FOR {what} must be an integer, "
                    f"got {t}")
            bounds.append(f)
        fs, fe, fstep = bounds
        body = self.statements(node.body)
        name, base, line = d.name, d.base, node.line
        dtype = DTYPES[base]

        def run(fr):
            i = _uniform_int(fs(fr), line, "FOR bound")
            stop = _uniform_int(fe(fr), line, "FOR bound")
            step = 1 if fstep is None else _uniform_int(fstep(fr), line,
                                                        "FOR step")
            if step == 0:
                raise STRuntimeError(f"line {line}: FOR step of zero")
            while (i <= stop) if step > 0 else (i >= stop):
                fr.vars[name] = dtype(i)
                for s in body:
                    s(fr)
                i += step
            # IEC leaves the counter undefined after the loop; pin it to the
            # first non-taken value for determinism.
            fr.vars[name] = _wrap_int(i, base)

        return run


def _neg_scalar(v, base):
    return _wrap_int(-int(v), base)


def _cast(v, dtype):
    if isinstance(v, np.ndarray):
        return v.astype(dtype)
    return dtype(v)


def _real_to_int(f, dst, line, *, rounder):
    lo, hi = INT_RANGES[dst]
    dtype = DTYPES[dst]

    def run(fr):
        r = rounder(f(fr))
        _check_active(~np.isfinite(r) | (r < lo) | (r > hi), fr.mask, line,
                      f"REAL value does not fit {dst}")
        return _cast(np.clip(r, lo, hi), dtype)

    return run


def _int_divmod(fa, fb, line, *, want_mod):
    def run(fr):
        a, b = fa(fr), fb(fr)
        bz = b == 0
        _check_active(bz, fr.mask, line, "division by zero")
        if np.any(bz):                # masked-off zero lanes: dummy divisor
            b = np.where(bz, np.asarray(1, dtype=np.asarray(b).dtype), b)
        q = np.floor_divide(a, b)
        r = a - q * b
        adj = np.logical_and(r != 0, (a < 0) != (b < 0))
        q = (q + adj).astype(np.asarray(q).dtype)   # floor -> trunc
        if want_mod:
            return (a - q * b) if isinstance(a, np.ndarray) or \
                isinstance(q, np.ndarray) else a - q * b
        return q

    return run


# ---------------------------------------------------------------------------
# Function block instances
# ---------------------------------------------------------------------------


def _init_scalar(d: _Decl):
    dtype = DTYPES[d.base]
    if d.init is None:
        return dtype(0) if d.base != "BOOL" else np.bool_(False)
    return _coerce_init(d, d.init)


def _coerce_init(d: _Decl, v):
    if d.base == "REAL":
        if isinstance(v, bool):
            raise STTypeError(f"{d.name}: BOOL initializer for REAL")
        return np.float32(v)
    if d.base == "BOOL":
        if not isinstance(v, bool):
            raise STTypeError(f"{d.name}: BOOL initializer must be "
                              "TRUE/FALSE")
        return np.bool_(v)
    if isinstance(v, float) or isinstance(v, bool):
        raise STTypeError(f"{d.name}: {d.base} initializer must be an "
                          "integer literal")
    lo, hi = INT_RANGES[d.base]
    if not lo <= v <= hi:
        raise STTypeError(
            f"{d.name}: initializer {v} out of {d.base} range [{lo}, {hi}]")
    return DTYPES[d.base](v)


class STFunctionBlock:
    """A parsed, compiled, *stateful* FUNCTION_BLOCK instance.

    :meth:`call` runs one invocation over a window batch and returns the
    ``VAR_OUTPUT`` values as ``(B,)`` / ``(B, size)`` arrays.  ``VAR`` and
    ``VAR_OUTPUT`` state persists across calls (FB instance semantics);
    :meth:`reset` re-runs the declaration initializers.
    """

    def __init__(self, text: str):
        parser = _Parser(tokenize(text))
        self.name, self._decls, self._order, stmts = \
            parser.parse_function_block()
        self._stmts = _Compiler(self._decls).statements(stmts)
        self._state: Dict[str, object] = {}
        self.reset()

    # -- declaration surface -----------------------------------------------

    def _section(self, section) -> List[_Decl]:
        return [self._decls[n] for n in self._order
                if self._decls[n].section == section]

    @property
    def inputs(self) -> List[_Decl]:
        return self._section("VAR_INPUT")

    @property
    def outputs(self) -> List[_Decl]:
        return self._section("VAR_OUTPUT")

    def reset(self) -> None:
        for name in self._order:
            d = self._decls[name]
            if d.is_array:
                if d.init is None:
                    z = _init_scalar(_Decl(name, d.base, None, None,
                                           d.section, False, None, d.line))
                    self._state[name] = [z] * d.size
                else:
                    self._state[name] = [_coerce_init(d, v) for v in d.init]
            else:
                self._state[name] = _init_scalar(d)

    # -- execution ----------------------------------------------------------

    def call(self, inputs: Dict[str, np.ndarray],
             batch: Optional[int] = None) -> Dict[str, np.ndarray]:
        """One FB invocation over a batch of lanes.

        ``inputs`` maps every VAR_INPUT name to ``(B, size)`` (arrays; a 1-D
        ``(size,)`` is taken as ``B=1``) or ``(B,)`` / scalar (scalars).
        Returns each VAR_OUTPUT as ``(B,)`` or ``(B, size)`` float/int
        arrays of the declared dtype.
        """
        decls_in = self.inputs
        names = {d.name for d in decls_in}
        for k in inputs:
            if k.upper() not in names:
                raise STRuntimeError(f"{k} is not a VAR_INPUT of {self.name}")
        staged = {}
        b = batch
        for d in decls_in:
            given = None
            for k, v in inputs.items():
                if k.upper() == d.name:
                    given = np.asarray(v)
            if given is None:
                raise STRuntimeError(f"missing input {d.name}")
            if d.is_array:
                if given.ndim == 1:
                    given = given[None, :]
                if given.ndim != 2 or given.shape[1] != d.size:
                    raise STRuntimeError(
                        f"input {d.name} wants (B, {d.size}), got "
                        f"{given.shape}")
            else:
                if given.ndim == 0:
                    given = given[None]
                if given.ndim != 1:
                    raise STRuntimeError(
                        f"input {d.name} wants (B,) or scalar, got "
                        f"{given.shape}")
            if given.shape[0] != 1:
                if b is None:
                    b = given.shape[0]
                elif given.shape[0] != b:
                    raise STRuntimeError(
                        f"inconsistent batch sizes: {b} vs "
                        f"{given.shape[0]} ({d.name})")
            staged[d.name] = given
        b = b or 1
        for d in decls_in:
            given = staged[d.name]
            if given.shape[0] == 1 and b > 1:
                given = np.broadcast_to(given, (b,) + given.shape[1:])
            dtype = DTYPES[d.base]
            if d.base in INT_TYPES:
                lo, hi = INT_RANGES[d.base]
                if np.any((given < lo) | (given > hi)):
                    raise STRuntimeError(
                        f"input {d.name} out of {d.base} range")
            given = given.astype(dtype)
            if d.is_array:
                self._state[d.name] = [
                    np.ascontiguousarray(given[:, j]) for j in range(d.size)]
            else:
                self._state[d.name] = np.ascontiguousarray(given)

        frame = _Frame(self._state, b)
        with np.errstate(all="ignore"):
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)
                for s in self._stmts:
                    s(frame)

        out = {}
        for d in self.outputs:
            v = self._state[d.name]
            if d.is_array:
                out[d.name] = np.stack(
                    [np.broadcast_to(np.asarray(c), (b,)) for c in v],
                    axis=1).copy()
            else:
                out[d.name] = np.broadcast_to(np.asarray(v), (b,)).copy()
        return out


def parse_function_block(text: str) -> STFunctionBlock:
    """Parse + compile one FUNCTION_BLOCK source into a callable instance."""
    return STFunctionBlock(text)
