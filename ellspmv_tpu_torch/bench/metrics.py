"""Derived-metric definition files (``--papi-event-file``): the counterpart
of ``ellspmv_tpu.bench.metrics``, the port's own copy (it is pure Python).

The reference's papi_util reads an event file listing hardware counters and
derived-metric formulas (`Metric [unit] = expr`), evaluates the formulas
over the measured counters, and prints plain or CSV reports
(papi_util.c:126-560). A card exposes no PAPI counters to this program, so
the same machinery runs over the quantities the bench harness measures and
the work model derives:

- the event-file format: metric names until a line starting with
  ``formulas``, then formula lines; ``#`` comments
  (read_eventfile, papi_util.c:496-560);
- formula expression trees over ``+ - * /``, parentheses, numbers, and
  names, with the case-insensitive pseudo-event ``time``
  (get_formula/_make_exptree/evaluate_exptree, papi_util.c:126-360);
- plain and CSV printers (print_values/print_values_csv,
  papi_util.c:424-494).

Available base events: time, iterations, nnz, flops, min_bytes, max_bytes,
devices, hbm_peak_bytes (the card's data-sheet peak; NaN on the CPU, which
has no device memory). An example file ships at
``examples/tpu_membw.metrics``.
"""

from __future__ import annotations

import dataclasses
import re


class MetricsError(ValueError):
    pass


# --- expression trees (papi_util.c:126-360) ---------------------------------

_TOKEN = re.compile(r"\s*(?:(\d+\.\d*(?:[eE][+-]?\d+)?|\.?\d+(?:[eE][+-]?\d+)?)"
                    r"|([A-Za-z_][A-Za-z0-9_.:]*)|([-+*/()]))")


@dataclasses.dataclass
class Expr:
    op: str                      # 'num' | 'name' | '+', '-', '*', '/'
    value: float = 0.0
    name: str = ""
    left: "Expr | None" = None
    right: "Expr | None" = None

    def evaluate(self, events: dict[str, float]) -> float:
        if self.op == "num":
            return self.value
        if self.op == "name":
            key = self.name.lower()
            if key not in events:
                raise MetricsError(f"unknown event {self.name!r} "
                                   f"(available: {sorted(events)})")
            return float(events[key])
        a = self.left.evaluate(events)
        b = self.right.evaluate(events)
        if self.op == "+":
            return a + b
        if self.op == "-":
            return a - b
        if self.op == "*":
            return a * b
        if self.op == "/":
            return a / b if b != 0 else float("inf")
        raise MetricsError(f"bad operator {self.op!r}")


def _tokenize(s: str) -> list[tuple[str, str]]:
    out, pos = [], 0
    while pos < len(s):
        m = _TOKEN.match(s, pos)
        if not m:
            if s[pos:].strip() == "":
                break
            raise MetricsError(f"bad token at {s[pos:]!r}")
        num, name, op = m.groups()
        if num is not None:
            out.append(("num", num))
        elif name is not None:
            out.append(("name", name))
        else:
            out.append(("op", op))
        pos = m.end()
    return out


class _Parser:
    """Recursive descent with standard precedence (the reference's
    _make_exptree splits at top-level +,- then *,/ — same grammar)."""

    def __init__(self, tokens):
        self.toks = tokens
        self.i = 0

    def peek(self):
        return self.toks[self.i] if self.i < len(self.toks) else (None, None)

    def next(self):
        t = self.peek()
        self.i += 1
        return t

    def parse(self) -> Expr:
        e = self.expr()
        if self.i != len(self.toks):
            raise MetricsError(f"trailing tokens: {self.toks[self.i:]}")
        return e

    def expr(self) -> Expr:
        node = self.term()
        while self.peek() == ("op", "+") or self.peek() == ("op", "-"):
            _, op = self.next()
            node = Expr(op=op, left=node, right=self.term())
        return node

    def term(self) -> Expr:
        node = self.factor()
        while self.peek() == ("op", "*") or self.peek() == ("op", "/"):
            _, op = self.next()
            node = Expr(op=op, left=node, right=self.factor())
        return node

    def factor(self) -> Expr:
        kind, val = self.next()
        if kind == "num":
            return Expr(op="num", value=float(val))
        if kind == "name":
            return Expr(op="name", name=val)
        if (kind, val) == ("op", "("):
            node = self.expr()
            if self.next() != ("op", ")"):
                raise MetricsError("missing ')'")
            return node
        if (kind, val) == ("op", "-"):
            return Expr(op="-", left=Expr(op="num", value=0.0),
                        right=self.factor())
        raise MetricsError(f"unexpected token {val!r}")


@dataclasses.dataclass
class Formula:
    """`Metric [unit] = expr` (get_formula's sscanf shape,
    papi_util.c:162-164)."""
    name: str
    unit: str
    expr: Expr


_FORMULA = re.compile(r"^\s*(\S+)\s*(?:\[([^\]]*)\])?\s*=\s*(.+)$")


def parse_formula(line: str) -> Formula:
    m = _FORMULA.match(line)
    if not m:
        raise MetricsError(f"invalid formula line: {line!r}")
    name, unit, rhs = m.groups()
    return Formula(name=name, unit=unit or "",
                   expr=_Parser(_tokenize(rhs)).parse())


@dataclasses.dataclass
class MetricsFile:
    events: list[str]
    formulas: list[Formula]


def read_metrics_file(path_or_file) -> MetricsFile:
    """Event names until a line starting with 'formulas' (case-insensitive),
    then formulas; '#' comments (read_eventfile, papi_util.c:496-560)."""
    own = not hasattr(path_or_file, "read")
    f = open(path_or_file) if own else path_or_file
    try:
        events, formulas = [], []
        in_formulas = False
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            if line.lower().startswith("formulas"):
                in_formulas = True
                continue
            if in_formulas:
                formulas.append(parse_formula(line))
            else:
                events.append(line)
        return MetricsFile(events=events, formulas=formulas)
    finally:
        if own:
            f.close()


# --- evaluation over bench results ----------------------------------------

def base_events(result, devices: int = 1) -> dict[str, float]:
    """The base events of a BenchResult (``bench/harness.py``)."""
    m = result.metrics
    return {
        "time": result.best,
        "iterations": float(len(result.times)),
        "nnz": float(m.num_nonzeros),
        "flops": float(m.num_flops),
        "min_bytes": float(m.min_bytes),
        "max_bytes": float(m.max_bytes),
        "devices": float(devices),
        "hbm_peak_bytes": (float("nan") if result.hbm_peak is None
                           else result.hbm_peak),
    }


def report(mfile: MetricsFile, events: dict[str, float], stream,
           fmt: str = "plain", region: str = "gemv") -> None:
    """Plain/CSV report (print_values / print_values_csv analogue,
    papi_util.c:424-494)."""
    known = {k: v for k, v in events.items()}
    listed = [e for e in mfile.events if e.lower() in known]
    values = [(f.name, f.unit, f.expr.evaluate(known))
              for f in mfile.formulas]
    if fmt == "csv":
        hdr = (["region"] + listed + [f.name for f in mfile.formulas]
               + ["time"])
        stream.write(",".join(hdr) + "\n")
        row = [region] + [repr(known[e.lower()]) for e in listed] + \
            [f"{v:.6g}" for _, _, v in values] + [f"{known['time']:.9f}"]
        stream.write(",".join(row) + "\n")
        return
    stream.write(f"Region: {region}\n")
    for e in listed:
        stream.write(f"  {e}: {known[e.lower()]:,.0f}\n")
    for name, unit, v in values:
        suffix = f" {unit}" if unit else ""
        stream.write(f"  {name}: {v:,.3f}{suffix}\n")
    stream.write(f"  Time: {known['time']:.6f} s\n")
