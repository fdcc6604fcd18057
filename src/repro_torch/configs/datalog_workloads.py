"""The paper's own workload configs (graph analytics + program analysis).

These drive the benchmarks (one per paper figure) and the PBME dry-run."""

from dataclasses import dataclass


@dataclass(frozen=True)
class DatalogWorkload:
    name: str
    program: str
    family: str                 # graph | program_analysis


TC = DatalogWorkload(
    "tc",
    """
    tc(x,y) :- arc(x,y).
    tc(x,y) :- tc(x,z), arc(z,y).
    """,
    "graph",
)

SG = DatalogWorkload(
    "sg",
    """
    sg(x,y) :- arc(p,x), arc(p,y), x != y.
    sg(x,y) :- arc(a,x), sg(a,b), arc(b,y).
    """,
    "graph",
)

REACH = DatalogWorkload(
    "reach",
    """
    reach(y) :- id(y).
    reach(y) :- reach(x), arc(x,y).
    """,
    "graph",
)

CC = DatalogWorkload(
    "cc",
    """
    cc3(x, MIN(x)) :- arc(x, _).
    cc3(y, MIN(z)) :- cc3(x, z), arc(x, y).
    cc2(x, MIN(y)) :- cc3(x, y).
    cc(x) :- cc2(_, x).
    """,
    "graph",
)

SSSP = DatalogWorkload(
    "sssp",
    """
    sssp2(y, MIN(0)) :- id(y).
    sssp2(y, MIN(d1+d2)) :- sssp2(x,d1), arc(x,y,d2).
    sssp(x, MIN(d)) :- sssp2(x,d).
    """,
    "graph",
)

ANDERSEN = DatalogWorkload(
    "andersen",
    """
    pointsTo(y,x) :- addressOf(y,x).
    pointsTo(y,x) :- assign(y,z), pointsTo(z,x).
    pointsTo(y,w) :- load(y,x), pointsTo(x,z), pointsTo(z,w).
    pointsTo(z,w) :- store(y,x), pointsTo(y,z), pointsTo(x,w).
    """,
    "program_analysis",
)

CSPA = DatalogWorkload(
    "cspa",
    """
    valueFlow(y,x) :- assign(y,x).
    valueFlow(x,y) :- assign(x,z), memoryAlias(z,y).
    valueFlow(x,y) :- valueFlow(x,z), valueFlow(z,y).
    memoryAlias(x,w) :- dereference(y,x), valueAlias(y,z), dereference(z,w).
    valueAlias(x,y) :- valueFlow(z,x), valueFlow(z,y).
    valueAlias(x,y) :- valueFlow(z,x), memoryAlias(z,w), valueFlow(w,y).
    valueFlow(x,x) :- assign(y,x).
    valueFlow(x,x) :- assign(x,y).
    memoryAlias(x,x) :- assign(y,x).
    memoryAlias(x,x) :- assign(x,y).
    """,
    "program_analysis",
)

CSDA = DatalogWorkload(
    "csda",
    """
    null(x,y) :- nullEdge(x,y).
    null(x,y) :- null(x,w), arc(w,y).
    """,
    "program_analysis",
)

ALL = {w.name: w for w in [TC, SG, REACH, CC, SSSP, ANDERSEN, CSPA, CSDA]}
