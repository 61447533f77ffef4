"""Phylogenetic tree: newick parsing + UPP-style centroid-edge decomposition.

Re-implements (from behavior, not code) the decomposition semantics of the
reference (witch_msa/gcmm/tree.py:363-438, witch_msa/gcmm/algorithm.py:84-132):

  * parse newick with underscores preserved
  * resolve polytomies to a binary tree (zero-length internal edges)
  * deroot (bifurcating root collapsed to a trifurcation)
  * hierarchical decomposition: record the *current* subtree's leaf set
    whenever it exceeds ``max_size`` (this nesting makes the HMM set an
    ensemble, including the full backbone as subset 0), then bisect at the
    centroid edge (most balanced leaf-count split with both sides >=
    ``min_size``) and recurse into (below-edge, remainder) in that order.

Ties in centroid selection are broken by postorder edge iteration order
(first minimal wins), matching the reference's dendropy traversal.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple


class Node:
    __slots__ = ("children", "parent", "length", "label")

    def __init__(self, label: Optional[str] = None,
                 length: Optional[float] = None):
        self.children: List["Node"] = []
        self.parent: Optional["Node"] = None
        self.length = length
        self.label = label

    def add_child(self, child: "Node"):
        child.parent = self
        self.children.append(child)

    def is_leaf(self) -> bool:
        return not self.children


class Tree:
    def __init__(self, root: Node):
        self.root = root

    # ------------------------------------------------------------ parsing
    @classmethod
    def from_newick(cls, text: str) -> "Tree":
        s = text.strip()
        if s.endswith(";"):
            s = s[:-1]
        pos = 0

        def parse_label() -> Tuple[Optional[str], int]:
            nonlocal pos
            if pos < len(s) and s[pos] == "'":
                # quoted label; '' escapes a quote
                end = pos + 1
                out = []
                while True:
                    if s[end] == "'":
                        if end + 1 < len(s) and s[end + 1] == "'":
                            out.append("'")
                            end += 2
                        else:
                            break
                    else:
                        out.append(s[end])
                        end += 1
                pos = end + 1
                return "".join(out), pos
            start = pos
            while pos < len(s) and s[pos] not in "(),:;":
                pos += 1
            if pos == start:
                return None, pos
            return s[start:pos], pos

        def parse_node() -> Node:
            nonlocal pos
            node = Node()
            if pos < len(s) and s[pos] == "(":
                pos += 1
                while True:
                    node.add_child(parse_node())
                    if s[pos] == ",":
                        pos += 1
                        continue
                    if s[pos] == ")":
                        pos += 1
                        break
            label, _ = parse_label()
            node.label = label
            if pos < len(s) and s[pos] == ":":
                pos += 1
                start = pos
                while pos < len(s) and s[pos] not in "(),;":
                    pos += 1
                node.length = float(s[start:pos])
            return node

        root = parse_node()
        return cls(root)

    # ---------------------------------------------------------- iteration
    def postorder(self):
        """Postorder node iteration, children visited in list order."""
        stack = [(self.root, False)]
        while stack:
            node, expanded = stack.pop()
            if expanded or node.is_leaf():
                yield node
            else:
                stack.append((node, True))
                for child in reversed(node.children):
                    stack.append((child, False))

    def leaves(self) -> List[Node]:
        return [n for n in self.postorder() if n.is_leaf()]

    def leaf_labels(self) -> List[str]:
        return [n.label for n in self.leaves()]

    def n_leaves(self) -> int:
        return sum(1 for n in self.postorder() if n.is_leaf())

    # ------------------------------------------------------ restructuring
    def resolve_polytomies(self):
        """Make the tree binary by grouping the first two children of any
        polytomy under a new zero-length node appended at the end of the
        child list (dendropy's deterministic rng=None behavior)."""
        for node in list(self.postorder()):
            while len(node.children) > 2:
                c1, c2 = node.children[0], node.children[1]
                new = Node(length=0.0)
                node.children = node.children[2:]
                new.add_child(c1)
                new.add_child(c2)
                node.add_child(new)

    def deroot(self):
        """Collapse a bifurcating root into its internal child, yielding a
        trifurcation (or higher)."""
        root = self.root
        if len(root.children) != 2:
            return
        c0, c1 = root.children
        collapse = c0 if not c0.is_leaf() else c1
        other = c1 if collapse is c0 else c0
        if collapse.is_leaf():
            return  # two-leaf tree; nothing to do
        root.children = [other]
        for cc in collapse.children:
            root.add_child(cc)
        if other.length is not None and collapse.length is not None:
            other.length += collapse.length

    # ------------------------------------------------------ decomposition
    def _leaf_counts(self) -> Dict[int, int]:
        counts: Dict[int, int] = {}
        for node in self.postorder():
            if node.is_leaf():
                counts[id(node)] = 1
            else:
                counts[id(node)] = sum(counts[id(c)] for c in node.children)
        return counts

    def centroid_edge(self, min_size: int) -> Optional[Node]:
        """Return the head node of the centroid edge, or None if the tree
        cannot be split (too few leaves)."""
        counts = self._leaf_counts()
        n = counts[id(self.root)]
        if n <= min_size:
            return None
        half = n / 2.0
        best = None
        best_imb = float(n)
        for node in self.postorder():
            if node.parent is None:
                continue
            below = counts[id(node)]
            if min_size is not None and (below < min_size or
                                         n - below < min_size):
                continue
            imb = abs(half - below)
            if imb < best_imb:
                best = node
                best_imb = imb
        return best

    def bipartition(self, head: Node) -> Tuple["Tree", "Tree"]:
        """Split at the edge above ``head``: (subtree below, remainder).

        The remainder suppresses the resulting unifurcation at the old
        tail node (edge lengths summed), as dendropy does.
        """
        tail = head.parent
        tail.children = [c for c in tail.children if c is not head]
        head.parent = None
        head.length = None
        t1 = Tree(head)
        # suppress unifurcation at tail
        if len(tail.children) == 1 and tail.parent is not None:
            child = tail.children[0]
            if child.length is not None and tail.length is not None:
                child.length += tail.length
            grand = tail.parent
            idx = grand.children.index(tail)
            grand.children[idx] = child
            child.parent = grand
        elif len(tail.children) == 1 and tail.parent is None:
            # root left with a single child: that child becomes the root
            child = tail.children[0]
            child.parent = None
            root = child
            return t1, Tree(root)
        root = tail
        while root.parent is not None:
            root = root.parent
        return t1, Tree(root)

    def decompose(self, max_size: int, min_size: int = 2,
                  hierarchical: bool = True,
                  _tree_map: Optional[List[List[str]]] = None,
                  _derooted: bool = False) -> List[List[str]]:
        """Hierarchical centroid decomposition; returns list of leaf-label
        lists in the reference's insertion order (self-before-split, then
        below-edge subtree, then remainder)."""
        if _tree_map is None:
            _tree_map = []
        if not _derooted:
            self.deroot()
        n = self.n_leaves()
        if hierarchical and n > max_size:
            _tree_map.append(self.leaf_labels())
        if n > max_size:
            head = self.centroid_edge(min_size)
            if head is not None:
                t1, t2 = self.bipartition(head)
                t1.decompose(max_size, min_size, hierarchical, _tree_map)
                t2.decompose(max_size, min_size, hierarchical, _tree_map)
            else:
                _tree_map.append(self.leaf_labels())
        else:
            _tree_map.append(self.leaf_labels())
        return _tree_map
