"""A directed graph of nodes (counterpart of
``bigdl_tpu.utils.directed_graph``; BigDL utils/DirectedGraph.scala:36,
``Node`` :183): the structure :class:`~bigdl_tpu_torch.nn.graph.Graph`
orders its modules by. Nodes hold an ``element`` (usually a module);
edges are directed and may select one slot of the source's output
table. Host-side metadata only.
"""
from __future__ import annotations

from typing import Any, Iterator, List, Optional


class Edge:
    __slots__ = ("from_index",)

    def __init__(self, from_index: Optional[int] = None):
        # 1-based index selecting a slot of the source node's output Table,
        # None = whole output (DirectedGraph.scala Edge semantics).
        self.from_index = from_index


class Node:
    """Graph node wrapping an element (usually a Module)."""

    def __init__(self, element: Any):
        self.element = element
        self.prevs: List[tuple] = []  # (node, edge)
        self.nexts: List[tuple] = []  # (node, edge)

    def add(self, other: "Node", edge: Optional[Edge] = None) -> "Node":
        """self -> other (DirectedGraph.scala:205)."""
        e = edge or Edge()
        if (other, e) not in self.nexts:
            self.nexts.append((other, e))
            other.prevs.append((self, e))
        return other

    def __call__(self, *prev_nodes):
        """Functional-API sugar: node(inputs...) wires inputs -> node."""
        for p in prev_nodes:
            if isinstance(p, tuple):  # (node, from_index)
                p[0].add(self, Edge(p[1]))
            else:
                p.add(self)
        return self

    def remove_prev_edges(self):
        for p, e in self.prevs:
            p.nexts = [(n, ee) for (n, ee) in p.nexts if n is not self]
        self.prevs = []

    def __repr__(self):
        return f"Node({self.element!r})"


class DirectedGraph:
    """DAG rooted at ``source``; ``reverse=True`` flips edge direction."""

    def __init__(self, source: Node, reverse: bool = False):
        self.source = source
        self.reverse = reverse

    def _next(self, node: Node):
        pairs = node.prevs if self.reverse else node.nexts
        return [n for n, _ in pairs]

    def _prev_count(self, node: Node) -> int:
        pairs = node.nexts if self.reverse else node.prevs
        return len(pairs)

    def bfs(self) -> Iterator[Node]:
        """Breadth-first traversal (DirectedGraph.scala:114)."""
        seen = set()
        queue = [self.source]
        while queue:
            node = queue.pop(0)
            if id(node) in seen:
                continue
            seen.add(id(node))
            yield node
            queue.extend(self._next(node))

    def dfs(self) -> Iterator[Node]:
        """Depth-first traversal (DirectedGraph.scala:87)."""
        seen = set()
        stack = [self.source]
        while stack:
            node = stack.pop()
            if id(node) in seen:
                continue
            seen.add(id(node))
            yield node
            stack.extend(reversed(self._next(node)))

    def topology_sort(self) -> List[Node]:
        """Kahn's algorithm from source (DirectedGraph.scala:54)."""
        nodes = list(self.bfs())
        indegree = {id(n): 0 for n in nodes}
        for n in nodes:
            for m in self._next(n):
                if id(m) in indegree:
                    indegree[id(m)] += 1
        ready = [n for n in nodes if indegree[id(n)] == 0]
        out: List[Node] = []
        while ready:
            n = ready.pop(0)
            out.append(n)
            for m in self._next(n):
                indegree[id(m)] -= 1
                if indegree[id(m)] == 0:
                    ready.append(m)
        if len(out) != len(nodes):
            raise ValueError("Graph contains a cycle")
        return out

    def size(self) -> int:
        return sum(1 for _ in self.bfs())
