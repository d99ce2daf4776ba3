"""The Graph container (counterpart of ``bigdl_tpu.nn.graph``; BigDL
nn/Graph.scala:72 with nn/Scheduler.scala:40).

Built with the wiring sugar of :class:`~bigdl_tpu_torch.nn.module.Module`
(a module called with no argument, or with a node, returns a
:class:`~bigdl_tpu_torch.utils.directed_graph.Node`)::

    inp = Input()()
    h = Linear(10, 4)(inp)
    out = LogSoftMax()(h)
    model = Graph(inp, out)

The nodes run in one topological order, fixed at construction (a
depth-first walk back from the outputs, as the JAX package's). Each
node's module is a submodule named as the JAX package names it — the
module's name, else its class name, then ``_1``, ``_2``, ... for
repeats — so the JAX param tree maps onto the Graph by name. A
``MergeOps`` node selects between its two branches by the predicate of
the ``SwitchOps`` that controls them, resolved at construction
(``control_ops``)."""
from __future__ import annotations

from typing import List, Optional, Sequence, Union

import torch

from bigdl_tpu_torch.nn.container import _run
from bigdl_tpu_torch.nn.control_ops import MergeOps, SwitchOps
from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.utils.directed_graph import Node
from bigdl_tpu_torch.utils.table import T, Table

__all__ = ["Graph", "Input"]


class Input(Module):
    """Graph input placeholder (nn/Input.scala): ``Input()()`` is a
    node; its forward is the identity."""

    def forward(self, x):
        return x


def _as_list(x) -> List[Node]:
    return [x] if isinstance(x, Node) else list(x)


def _slot(value, index: int):
    """The 1-based ``index``-th entry of a node's output table (a Table,
    or the list a port table module returns)."""
    return value[index] if isinstance(value, Table) else value[index - 1]


class Graph(Module):
    """A DAG of module nodes with explicit input and output nodes
    (several of either: the input is then a table, and so is the
    output). ``forward(x, generator=None)`` hands ``generator`` to each
    node whose forward takes one, in the execution order."""

    def __init__(self, input: Union[Node, Sequence[Node]],
                 output: Union[Node, Sequence[Node]]):
        super().__init__()
        self.input_nodes = _as_list(input)
        self.output_nodes = _as_list(output)
        self.exec_order = self._topo_sort()
        pos = {id(n): i for i, n in enumerate(self.exec_order)}
        counts = {}
        names = []
        for n in self.exec_order:
            base = n.element._name or type(n.element).__name__
            if base in counts:
                counts[base] += 1
                names.append(f"{base}_{counts[base]}")
            else:
                counts[base] = 0
                names.append(base)
        self.names = names
        for n, name in zip(self.exec_order, names):
            self.add_module(name, n.element)
        # each node's inputs as positions in the order (a copy of the
        # Graph keeps them): ("input", k), ("all", None) for a source
        # that is no graph input, or ("prev", [(position, from_index)])
        self._feeds = []
        for n in self.exec_order:
            inp = next((k for k, m in enumerate(self.input_nodes)
                        if m is n), None)
            if inp is not None:
                self._feeds.append(("input", inp))
            elif not n.prevs:
                self._feeds.append(("all", None))
            else:
                self._feeds.append(("prev", [(pos[id(p)], e.from_index)
                                             for p, e in n.prevs]))
        self._merges = {pos[id(n)]: (pos[id(info[0][0])], info[0][1])
                        for n, info in self._resolve_merges()}
        self._switches = frozenset(
            i for i, n in enumerate(self.exec_order)
            if isinstance(n.element, SwitchOps))
        self._outputs = [pos[id(n)] for n in self.output_nodes]

    @property
    def jax_tree_children(self):
        """Every node's name: the JAX trees hold one entry a node,
        ``{}`` for a parameterless one."""
        return tuple(self.names)

    def _topo_sort(self) -> List[Node]:
        seen = {}
        order: List[Node] = []

        def visit(n: Node):
            if id(n) in seen:
                if seen[id(n)] == 1:
                    raise ValueError("Graph contains a cycle")
                return
            seen[id(n)] = 1
            for p, _ in n.prevs:
                visit(p)
            seen[id(n)] = 2
            order.append(n)

        for out in self.output_nodes:
            visit(out)
        return order

    def _resolve_merges(self):
        """``[(merge node, [(switch node, branch), (switch node,
        branch)])]``: each MergeOps input's controlling Switch and
        branch (1 the false output, 2 the true one), by a walk back
        from the input (Scheduler.scala:118-130's availability, at
        construction)."""
        def find_switch(node, edge, seen):
            if id(node) in seen:
                return None
            seen.add(id(node))
            if isinstance(node.element, SwitchOps):
                return (node, edge.from_index if edge.from_index is not None
                        else 1)
            for p, e in node.prevs:
                found = find_switch(p, e, seen)
                if found is not None:
                    return found
            return None

        def pred_node(sw):
            return sw.prevs[1][0] if len(sw.prevs) > 1 else None

        out = []
        for n in self.exec_order:
            if not isinstance(n.element, MergeOps):
                continue
            info = [find_switch(p, e, set()) for p, e in n.prevs]
            if len(info) != 2 or any(i is None for i in info):
                raise ValueError(
                    "MergeOps in a Graph needs exactly two inputs, each "
                    "reachable from a SwitchOps branch")
            if info[0][0] is not info[1][0] and (
                    pred_node(info[0][0]) is None
                    or pred_node(info[0][0]) is not pred_node(info[1][0])):
                raise ValueError(
                    "MergeOps inputs resolve to two different predicates "
                    "(nested conditionals): restructure with IfThenElse, "
                    "which nests")
            if {info[0][1], info[1][1]} != {1, 2}:
                raise ValueError(
                    "MergeOps inputs must come from the two distinct "
                    "branches (1=false, 2=true) of a Switch")
            out.append((n, info))
        return out

    def forward(self, input, generator: Optional[torch.Generator] = None):
        inputs = [input] if len(self.input_nodes) == 1 else list(input)
        values = []
        preds = {}
        for i, (name, (kind, feed)) in enumerate(zip(self.names,
                                                     self._feeds)):
            if kind == "input":
                node_in = inputs[feed]
            elif kind == "all":
                node_in = input
            else:
                gathered = [values[j] if k is None else _slot(values[j], k)
                            for j, k in feed]
                node_in = gathered[0] if len(gathered) == 1 \
                    else T(*gathered)
            if i in self._merges:
                switch, branch = self._merges[i]
                vals = list(node_in)
                t = 0 if branch == 2 else 1
                out = MergeOps.select(preds[switch], vals[t], vals[1 - t])
            else:
                if i in self._switches:
                    preds[i] = list(node_in)[1]
                out = _run(self._modules[name], node_in, generator)
            values.append(out)
        outs = [values[j] for j in self._outputs]
        return outs[0] if len(outs) == 1 else T(*outs)

    def regularization_loss(self):
        return sum(self._modules[name].regularization_loss()
                   for name in self.names)

    def param_scales(self):
        # the nodes' own scales: as in the JAX package, ``freeze()`` on
        # the Graph itself sets scales that nothing reads
        out = {}
        for name in self.names:
            out.update((f"{name}.{k}", s) for k, s in
                       self._modules[name].param_scales().items())
        return out

    def find(self, name: str) -> Optional[Module]:
        """The node module named ``name`` (``get_name``), or None."""
        for key in self.names:
            if self._modules[key].get_name() == name:
                return self._modules[key]
        return None
