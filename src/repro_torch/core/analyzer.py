"""Rule analyzer: dependency graph, stratification, recursion classes (paper §3.1, §4).

Builds the predicate dependency graph, computes strongly-connected components
(strata) with a topological order, verifies stratified negation, and
classifies each stratum (non-recursive / linear / non-linear / mutual
recursion / recursive-aggregate).  Mirrors the paper's *rule analyzer* stage.

The graph is a plain adjacency dict, ``{pred: {successor: negated}}``, whose
key order is insertion order.  The SCC walk (Tarjan with Nuutila's
modification, iterative) and the generation-by-generation topological sort
visit nodes and edges in that order, so the strata come out in one fixed
order for a given program text; the negative-cycle witness is a
bidirectional BFS over the edges in order of first occurrence.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.core.ast import Agg, Program, Rule

Graph = dict[str, dict[str, bool]]


@dataclass
class Stratum:
    index: int
    preds: list[str]
    rules: list[Rule]
    recursive: bool
    nonlinear: bool = False
    mutual: bool = False
    has_recursive_agg: bool = False

    def rules_for(self, pred: str) -> list[Rule]:
        return [r for r in self.rules if r.head_pred == pred]


@dataclass
class Stratification:
    program: Program
    strata: list[Stratum]
    idb: list[str]
    edb: list[str]
    graph: Graph = field(repr=False, default_factory=dict)

    def pred_arity(self, pred: str) -> int:
        return self.program.arity_of(pred)


def dependency_edges(program: Program) -> dict[tuple[str, str], bool]:
    """Edges ``(body_pred, head_pred)`` per IDB body occurrence, in order of
    first occurrence, each with ``negated=True`` if *any* occurrence is."""
    idb = set(program.idb_preds)
    edges: dict[tuple[str, str], bool] = {}
    for rule in program.rules:
        for atom in rule.atoms:
            if atom.pred in idb:
                e = (atom.pred, rule.head_pred)
                edges[e] = atom.negated or edges.get(e, False)
    return edges


def dependency_graph(program: Program) -> Graph:
    """Predicate dependency graph as ``{pred: {successor: negated}}``."""
    g: Graph = {p: {} for p in program.idb_preds}
    for (u, v), negated in dependency_edges(program).items():
        g[u][v] = negated
    return g


def strongly_connected_components(g: Graph) -> list[set[str]]:
    """SCCs in discovery order (iterative Tarjan, Nuutila's variant)."""
    preorder: dict[str, int] = {}
    lowlink: dict[str, int] = {}
    found: set[str] = set()
    scc_stack: list[str] = []
    out: list[set[str]] = []
    counter = 0
    succ_iter = {v: iter(g[v]) for v in g}
    for source in g:
        if source in found:
            continue
        stack = [source]
        while stack:
            v = stack[-1]
            if v not in preorder:
                counter += 1
                preorder[v] = counter
            done = True
            for w in succ_iter[v]:
                if w not in preorder:
                    stack.append(w)
                    done = False
                    break
            if not done:
                continue
            low = preorder[v]
            for w in g[v]:
                if w not in found:
                    low = min(low, lowlink[w] if preorder[w] > preorder[v] else preorder[w])
            lowlink[v] = low
            stack.pop()
            if low == preorder[v]:
                scc = {v}
                while scc_stack and preorder[scc_stack[-1]] > preorder[v]:
                    scc.add(scc_stack.pop())
                found |= scc
                out.append(scc)
            else:
                scc_stack.append(v)
    return out


def condensation_order(g: Graph, sccs: list[set[str]]) -> list[int]:
    """Indices into ``sccs`` in topological order of the condensed DAG
    (Kahn's algorithm, one generation at a time)."""
    comp = {p: i for i, scc in enumerate(sccs) for p in scc}
    succ: list[dict[int, None]] = [{} for _ in sccs]
    for u, targets in g.items():
        for v in targets:
            if comp[u] != comp[v]:
                succ[comp[u]].setdefault(comp[v])
    indegree = [0] * len(sccs)
    for targets in succ:
        for c in targets:
            indegree[c] += 1
    generation = [c for c in range(len(sccs)) if indegree[c] == 0]
    order: list[int] = []
    while generation:
        order.extend(generation)
        nxt = []
        for c in generation:
            for child in succ[c]:
                indegree[child] -= 1
                if indegree[child] == 0:
                    nxt.append(child)
        generation = nxt
    return order


def _shortest_path(
    edges: dict[tuple[str, str], bool], source: str, target: str
) -> list[str] | None:
    """Bidirectional BFS: grow the smaller fringe one level at a time, each
    node's successors and predecessors in edge order; stop at the first
    meeting node."""
    succ: dict[str, list[str]] = {}
    pred: dict[str, list[str]] = {}
    for u, v in edges:
        succ.setdefault(u, []).append(v)
        pred.setdefault(v, []).append(u)
    if source == target:
        return [source]
    back: dict[str, str | None] = {source: None}      # toward source
    fwd: dict[str, str | None] = {target: None}       # toward target
    front, rear = [source], [target]
    meet = None
    while front and rear and meet is None:
        if len(front) <= len(rear):
            level, front = front, []
            for v in level:
                for w in succ.get(v, ()):
                    if w not in back:
                        front.append(w)
                        back[w] = v
                    if w in fwd:
                        meet = w
                        break
                if meet is not None:
                    break
        else:
            level, rear = rear, []
            for v in level:
                for w in pred.get(v, ()):
                    if w not in fwd:
                        fwd[w] = v
                        rear.append(w)
                    if w in back:
                        meet = w
                        break
                if meet is not None:
                    break
    if meet is None:
        return None
    path = [meet]
    while back[path[-1]] is not None:
        path.append(back[path[-1]])
    path.reverse()
    while fwd[path[-1]] is not None:
        path.append(fwd[path[-1]])
    return path


def negative_cycle_witness(
    edges: dict[tuple[str, str], bool], head_pred: str, neg_pred: str
) -> str:
    """Render the dependency cycle violating stratified negation.

    ``head_pred`` negates ``neg_pred`` inside their shared SCC; the witness
    is a shortest dependency path ``head_pred -> ... -> neg_pred`` closed by
    the negated edge back to ``head_pred``.
    """
    path = _shortest_path(edges, head_pred, neg_pred) or [head_pred, neg_pred]
    return " -> ".join(path) + f" -[negated]-> {head_pred}"


def analyze(program: Program) -> Stratification:
    program.validate()

    edges = dependency_edges(program)
    g = dependency_graph(program)
    sccs = strongly_connected_components(g)

    strata: list[Stratum] = []
    for comp_id in condensation_order(g, sccs):
        preds = sorted(sccs[comp_id])
        pred_set = set(preds)
        rules = [r for r in program.rules if r.head_pred in pred_set]
        if not rules:
            continue
        # recursive iff some rule's body references a pred of this SCC
        recursive = any(
            a.pred in pred_set for r in rules for a in r.atoms
        )
        # stratified-negation check: no negated edge inside an SCC
        for r in rules:
            for a in r.atoms:
                if a.negated and a.pred in pred_set:
                    witness = negative_cycle_witness(edges, r.head_pred, a.pred)
                    raise ValueError(
                        f"unstratifiable negation: {a.pred} negated within "
                        f"its own stratum in rule {r} "
                        f"(negative cycle: {witness})"
                    )
        nonlinear = any(
            sum(1 for a in r.positive_atoms if a.pred in pred_set) > 1
            for r in rules
        )
        mutual = len(preds) > 1
        rec_agg = recursive and any(r.has_aggregate for r in rules)
        if rec_agg:
            for r in rules:
                for t in r.head_terms:
                    if isinstance(t, Agg) and t.op not in ("MIN", "MAX"):
                        # recursion over a non-monotonic-lattice aggregate:
                        # convergence is the user's responsibility (paper §3.3
                        # assumes programs converge); we restrict to MIN/MAX
                        # whose fixpoint always exists.
                        raise ValueError(
                            f"recursive aggregate {t.op} unsupported "
                            f"(only MIN/MAX converge unconditionally): {r}"
                        )
        strata.append(
            Stratum(
                index=len(strata),
                preds=preds,
                rules=rules,
                recursive=recursive,
                nonlinear=nonlinear,
                mutual=mutual,
                has_recursive_agg=rec_agg,
            )
        )

    return Stratification(
        program=program,
        strata=strata,
        idb=program.idb_preds,
        edb=program.edb_preds,
        graph=g,
    )
