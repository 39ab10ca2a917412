"""Regex -> NFA -> DFA compiler (host-side, feeds kernels/dfa_match.py).

A copy of `repro/core/regex.py` (numpy only): the same pattern gives the
same transition table and accept vector, byte for byte, and the same
errors.

Farview integrates an FPGA regex library [42]; the DFA is built offline and
loaded into the operator. We mirror that split: this module compiles a
pattern into an int32 (S, 256) transition table + accept vector, which the
dfa_match kernel executes at "line rate" (cost independent of pattern
complexity — exactly the paper's claim, which holds here too since the DFA
table shape is what enters the kernel, not the pattern).

Supported syntax: literals, '.', escapes, character classes [a-z0-9^...],
grouping (), alternation |, quantifiers * + ?.
Semantics: `search` (unanchored, like SQL LIKE '%..%' / RE2 partial match):
the DFA is built for the pattern with a `.*` self-loop on the start state
and *absorbing* accept states, so "ever matched" == "final state accepting".
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

ALPHA = 256
EPS = -1


@dataclass
class _NfaState:
    edges: list = field(default_factory=list)  # (char_set frozenset | None=eps, target)


class _Parser:
    """Recursive-descent regex parser producing an NFA fragment."""

    def __init__(self, pattern: str):
        self.p = pattern
        self.i = 0
        self.states: list[_NfaState] = []

    def _new(self) -> int:
        self.states.append(_NfaState())
        return len(self.states) - 1

    def _edge(self, a: int, b: int, chars):
        self.states[a].edges.append((chars, b))

    def peek(self):
        return self.p[self.i] if self.i < len(self.p) else None

    def eat(self):
        c = self.p[self.i]
        self.i += 1
        return c

    # fragment = (start, end)
    def parse(self):
        frag = self.alternation()
        if self.i != len(self.p):
            raise ValueError(f"trailing chars in regex at {self.i}: {self.p}")
        return frag

    def alternation(self):
        frags = [self.concat()]
        while self.peek() == "|":
            self.eat()
            frags.append(self.concat())
        if len(frags) == 1:
            return frags[0]
        s, e = self._new(), self._new()
        for fs, fe in frags:
            self._edge(s, fs, None)
            self._edge(fe, e, None)
        return s, e

    def concat(self):
        frags = []
        while self.peek() is not None and self.peek() not in "|)":
            frags.append(self.quantified())
        if not frags:
            s = self._new()
            return s, s
        s, e = frags[0]
        for fs, fe in frags[1:]:
            self._edge(e, fs, None)
            e = fe
        return s, e

    def quantified(self):
        frag = self.atom()
        while self.peek() in ("*", "+", "?"):
            q = self.eat()
            fs, fe = frag
            s, e = self._new(), self._new()
            self._edge(s, fs, None)
            self._edge(fe, e, None)
            if q in ("*", "?"):
                self._edge(s, e, None)
            if q in ("*", "+"):
                self._edge(fe, fs, None)
            frag = (s, e)
        return frag

    def atom(self):
        c = self.peek()
        if c == "(":
            self.eat()
            frag = self.alternation()
            if self.peek() != ")":
                raise ValueError("unbalanced paren")
            self.eat()
            return frag
        if c == "[":
            return self.char_class()
        if c == ".":
            self.eat()
            return self.char_frag(frozenset(range(ALPHA)))
        if c == "\\":
            self.eat()
            lit = self.eat()
            mapped = {"n": "\n", "t": "\t", "r": "\r",
                      "d": None, "w": None, "s": None}
            if lit == "d":
                return self.char_frag(frozenset(ord(x) for x in "0123456789"))
            if lit == "w":
                cs = set(range(ord("a"), ord("z") + 1))
                cs |= set(range(ord("A"), ord("Z") + 1))
                cs |= set(range(ord("0"), ord("9") + 1)) | {ord("_")}
                return self.char_frag(frozenset(cs))
            if lit == "s":
                return self.char_frag(frozenset(ord(x) for x in " \t\n\r\f\v"))
            ch = mapped.get(lit)
            return self.char_frag(frozenset({ord(ch if ch else lit)}))
        if c is None:
            raise ValueError("unexpected end of regex")
        self.eat()
        return self.char_frag(frozenset({ord(c)}))

    def char_frag(self, chars):
        s, e = self._new(), self._new()
        self._edge(s, e, chars)
        return s, e

    def char_class(self):
        self.eat()  # '['
        negate = False
        if self.peek() == "^":
            negate = True
            self.eat()
        chars: set[int] = set()
        while self.peek() != "]":
            c = self.eat()
            if c is None:
                raise ValueError("unterminated char class")
            if c == "\\":
                c = self.eat()
            if self.peek() == "-" and self.p[self.i + 1:self.i + 2] != "]":
                self.eat()
                hi = self.eat()
                chars.update(range(ord(c), ord(hi) + 1))
            else:
                chars.add(ord(c))
        self.eat()  # ']'
        if negate:
            chars = set(range(ALPHA)) - chars
        return self.char_frag(frozenset(chars))


def compile_regex(pattern: str, *, search: bool = True,
                  max_states: int = 64):
    """Compile pattern -> (table (S,256) int32, accept (S,) bool).

    search=True gives unanchored (substring) semantics with absorbing accept
    states; search=False anchors at ^...$ (full match).
    """
    parser = _Parser(pattern)
    start, end = parser.parse()
    nfa = parser.states

    # epsilon closures
    def eclose(states: frozenset[int]) -> frozenset[int]:
        stack, seen = list(states), set(states)
        while stack:
            s = stack.pop()
            for chars, t in nfa[s].edges:
                if chars is None and t not in seen:
                    seen.add(t)
                    stack.append(t)
        return frozenset(seen)

    start_set = eclose(frozenset({start}))
    dfa_index: dict[frozenset, int] = {start_set: 0}
    rows: list[np.ndarray] = []
    accepts: list[bool] = []
    work = [start_set]

    while work:
        cur = work.pop(0)
        idx = dfa_index[cur]
        is_acc = end in cur
        while len(rows) <= idx:
            rows.append(np.zeros((ALPHA,), np.int32))
            accepts.append(False)
        accepts[idx] = is_acc
        if search and is_acc:
            # absorbing accept state: all chars self-loop
            rows[idx] = np.full((ALPHA,), idx, np.int32)
            continue
        # group targets by char
        per_char: list[set[int]] = [set() for _ in range(ALPHA)]
        for s in cur:
            for chars, t in nfa[s].edges:
                if chars is None:
                    continue
                for ch in chars:
                    per_char[ch].add(t)
        if search:
            # '.*' prefix: start states always reachable
            base = start_set
        else:
            base = frozenset()
        row = np.zeros((ALPHA,), np.int32)
        cache: dict[frozenset, int] = {}
        for ch in range(ALPHA):
            tgt = frozenset(per_char[ch])
            key = tgt
            if key in cache:
                row[ch] = cache[key]
                continue
            nxt = eclose(tgt) | base if search else eclose(tgt)
            if search:
                nxt = eclose(frozenset(nxt))
            if not nxt:
                nxt = base if search else frozenset()
            if not nxt:
                # dead state: map to a dedicated dead state (reuse state 0 if
                # anchored-dead semantics needed). Create explicit dead state.
                nxt = frozenset({-2})
            if nxt not in dfa_index:
                if len(dfa_index) >= max_states:
                    raise ValueError(
                        f"DFA exceeds max_states={max_states} for {pattern!r}")
                dfa_index[nxt] = len(dfa_index)
                if nxt != frozenset({-2}):
                    work.append(nxt)
            row[ch] = dfa_index[nxt]
            cache[key] = row[ch]
        rows[idx] = row

    n = len(dfa_index)
    table = np.zeros((n, ALPHA), np.int32)
    accept = np.zeros((n,), bool)
    for st, idx in dfa_index.items():
        if idx < len(rows):
            table[idx] = rows[idx]
            accept[idx] = accepts[idx] if idx < len(accepts) else False
        if st == frozenset({-2}):
            table[idx] = idx  # dead state self-loops
            accept[idx] = False
    return table, accept
