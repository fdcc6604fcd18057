"""Parser for the paper's Datalog surface syntax.

Grammar (per paper §3 and §6.2 benchmark programs)::

    program  := (rule '.')*
    rule     := atom ':-' body | atom            (facts allowed)
    body     := item (',' item)*
    item     := ['!'|'¬'] pred '(' terms ')' | term cmp term
    term     := var | int | '_'
    headterm := term | AGG '(' expr ')'
    expr     := addend ('+' addend)*

Comments: ``// ...`` and ``% ...`` to end of line.

Every rule, atom, and comparison carries a :class:`~repro_torch.core.ast.Span`
(1-based line/col of its first token) so downstream diagnostics
can point at source.  Syntax errors raise
:class:`DatalogSyntaxError` with ``lineno``/``offset`` set.
"""

from __future__ import annotations

import re

from repro_torch.core.ast import (
    AGG_OPS,
    Agg,
    Atom,
    Cmp,
    Const,
    Expr,
    Program,
    Rule,
    Span,
    Var,
)

_TOKEN = re.compile(
    r"\s*(?:(?P<comment>(?://|%)[^\n]*)"
    r"|(?P<name>[A-Za-z_][A-Za-z0-9_]*)"
    r"|(?P<int>-?\d+)"
    r"|(?P<op>:-|!=|==|<=|>=|<|>|=|\+|!|¬|\(|\)|,|\.)"
    r")"
)

_NAME = re.compile(r"[A-Za-z_][A-Za-z0-9_]*")
_INT = re.compile(r"-?\d+")


class DatalogSyntaxError(SyntaxError):
    """Syntax error with source location (``lineno``/``offset``, 1-based)."""

    def __init__(self, message: str, line: int | None = None, col: int | None = None):
        loc = f" at line {line}, col {col}" if line is not None else ""
        super().__init__(message + loc)
        self.lineno = line
        self.offset = col

    @property
    def span(self) -> Span | None:
        if self.lineno is None:
            return None
        return Span(self.lineno, self.offset or 1)


class _Tok:
    __slots__ = ("text", "line", "col")

    def __init__(self, text: str, line: int, col: int):
        self.text = text
        self.line = line
        self.col = col

    @property
    def span(self) -> Span:
        return Span(self.line, self.col)


def _tokenize(text: str) -> list[_Tok]:
    line_starts = [0]
    for i, c in enumerate(text):
        if c == "\n":
            line_starts.append(i + 1)

    def loc(offset: int) -> tuple[int, int]:
        lo, hi = 0, len(line_starts) - 1
        while lo < hi:                      # rightmost line start <= offset
            mid = (lo + hi + 1) // 2
            if line_starts[mid] <= offset:
                lo = mid
            else:
                hi = mid - 1
        return lo + 1, offset - line_starts[lo] + 1

    tokens: list[_Tok] = []
    pos = 0
    while pos < len(text):
        m = _TOKEN.match(text, pos)
        if not m or m.lastgroup is None:
            rest = text[pos:]
            if rest.strip() == "":
                break
            bad = pos + len(rest) - len(rest.lstrip())
            line, col = loc(bad)
            raise DatalogSyntaxError(
                f"bad token at: {text[bad:bad + 30]!r}", line, col
            )
        pos = m.end()
        if m.lastgroup == "comment":
            continue
        start = m.start(m.lastgroup)
        line, col = loc(start)
        tokens.append(_Tok(m.group(m.lastgroup), line, col))
    return tokens


class _Parser:
    def __init__(self, tokens: list[_Tok]):
        self.toks = tokens
        self.i = 0

    def peek(self) -> str | None:
        return self.toks[self.i].text if self.i < len(self.toks) else None

    def peek_at(self, offset: int) -> str | None:
        j = self.i + offset
        return self.toks[j].text if j < len(self.toks) else None

    def span(self) -> Span | None:
        if self.i < len(self.toks):
            return self.toks[self.i].span
        if self.toks:
            return self.toks[-1].span
        return None

    def _error(self, message: str) -> DatalogSyntaxError:
        sp = self.span()
        return DatalogSyntaxError(
            message, sp.line if sp else None, sp.col if sp else None
        )

    def pop(self, expect: str | None = None) -> str:
        if self.i >= len(self.toks):
            raise self._error("unexpected end of program")
        t = self.toks[self.i].text
        if expect is not None and t != expect:
            raise self._error(f"expected {expect!r}, got {t!r}")
        self.i += 1
        return t

    def parse_program(self, validate: bool = True) -> Program:
        prog = Program()
        while self.peek() is not None:
            prog.rules.append(self.parse_rule())
        if validate:
            prog.validate()
        return prog

    def parse_rule(self) -> Rule:
        span = self.span()
        head_pred, head_terms = self.parse_head()
        body: list = []
        if self.peek() == ":-":
            self.pop(":-")
            body.append(self.parse_body_item())
            while self.peek() == ",":
                self.pop(",")
                body.append(self.parse_body_item())
        self.pop(".")
        return Rule(head_pred, tuple(head_terms), tuple(body), span=span)

    def parse_head(self):
        pred = self.pop()
        self.pop("(")
        terms: list = []
        while True:
            terms.append(self.parse_head_term())
            if self.peek() == ",":
                self.pop(",")
                continue
            break
        self.pop(")")
        return pred, terms

    def parse_head_term(self):
        t = self.peek()
        if t is None:
            raise self._error("unexpected end of program")
        if t.upper() in AGG_OPS and self.peek_at(1) == "(":
            self.pop()
            self.pop("(")
            expr = self.parse_expr()
            self.pop(")")
            return Agg(t.upper(), expr)
        return self.parse_term()

    def parse_expr(self) -> Expr:
        vars_: list[Var] = []
        const = 0
        while True:
            t = self.parse_term()
            if isinstance(t, Var):
                vars_.append(t)
            else:
                const += t.value
            if self.peek() == "+":
                self.pop("+")
                continue
            break
        return Expr(tuple(vars_), const)

    def parse_term(self):
        t = self.pop()
        if _INT.fullmatch(t):
            return Const(int(t))
        if not _NAME.fullmatch(t):
            raise self._error(f"expected term, got {t!r}")
        return Var(t)

    def parse_body_item(self):
        span = self.span()
        negated = False
        if self.peek() in ("!", "¬"):
            # negation only if followed by a predicate atom
            if self.peek_at(1) is not None and self.peek_at(2) == "(":
                self.pop()
                negated = True
        # lookahead: atom `p(...)` vs comparison `t op t`
        if (
            self.peek() is not None
            and _NAME.fullmatch(self.toks[self.i].text)
            and self.peek_at(1) == "("
        ):
            pred = self.pop()
            self.pop("(")
            terms: list = [self.parse_term()]
            while self.peek() == ",":
                self.pop(",")
                terms.append(self.parse_term())
            self.pop(")")
            return Atom(pred, tuple(terms), negated=negated, span=span)
        lhs = self.parse_term()
        op = self.pop()
        if op == "=":
            op = "=="
        rhs = self.parse_term()
        if op not in ("==", "!=", "<", "<=", ">", ">="):
            raise self._error(f"expected comparison operator, got {op!r}")
        return Cmp(op, lhs, rhs, span=span)


def parse(text: str, validate: bool = True) -> Program:
    """Parse Datalog source text into a :class:`Program`.

    ``validate=True`` (the default) raises ``ValueError`` on the first
    safety/arity violation; ``validate=False`` skips the checks.
    """
    return _Parser(_tokenize(text)).parse_program(validate=validate)
