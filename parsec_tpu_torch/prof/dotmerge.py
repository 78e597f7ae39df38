"""Multi-rank DOT merger: the ``parsec-dotmerger`` role.

Port of ``parsec_tpu/prof/dotmerge.py``: each rank's grapher
(:mod:`parsec_tpu_torch.prof.grapher`) writes the local part of the DAG;
this tool unions N per-rank ``.dot`` files into one graph, tags each
node with the rank(s) that ran it and dashes the cross-rank edges (an
edge whose endpoints were written by disjoint rank sets).

::

    python -m parsec_tpu_torch.prof.dotmerge rank0.dot rank1.dot -o merged.dot

Left out: nothing of the module.
"""

from __future__ import annotations

import re
import sys

# the grapher's emission subset: quoted ids, bracketed attr lists
_RE_NODE = re.compile(r'^\s*"([^"]+)"\s*(\[[^\]]*\])?\s*;\s*$')
_RE_EDGE = re.compile(
    r'^\s*"([^"]+)"\s*->\s*"([^"]+)"\s*(\[[^\]]*\])?\s*;\s*$')
_RE_ATTR = re.compile(r'(\w+)\s*=\s*"([^"]*)"')


def parse_dot(text: str) -> tuple[dict, dict]:
    """Parse the grapher's DOT subset: ``nodes[id] -> attrs``,
    ``edges[(src, dst, label)] -> attrs``.  The label is part of the
    edge key — the grapher emits one edge per (src, dst, FLOW) and two
    flows between the same pair are two distinct dependencies."""
    nodes: dict[str, dict] = {}
    edges: dict[tuple, dict] = {}
    for line in text.splitlines():
        m = _RE_EDGE.match(line)
        if m:
            attrs = dict(_RE_ATTR.findall(m.group(3) or ""))
            edges[(m.group(1), m.group(2),
                   attrs.get("label", ""))] = attrs
            continue
        m = _RE_NODE.match(line)
        if m and m.group(1) not in ("node", "edge", "graph"):
            nodes[m.group(1)] = dict(_RE_ATTR.findall(m.group(2) or ""))
    return nodes, edges


_RE_RANK = re.compile(r"rank(\d+)")


def _rank_of(path: str, position: int) -> str:
    """Rank tag for a fragment: the ``rank<N>`` in its filename when
    present (shell globs sort rank10 before rank2 — argv position would
    mislabel), else the argv position."""
    m = _RE_RANK.search(path.rsplit("/", 1)[-1])
    return m.group(1) if m else str(position)


def merge(paths: list[str]) -> tuple[dict, dict]:
    """Union the per-rank graphs; node attrs from the first rank that
    defined them win, plus a ``ranks`` attr listing every definer (a
    node executed on exactly one rank normally — several definers mark
    a replicated/ghost node worth seeing)."""
    nodes: dict[str, dict] = {}
    edges: dict[tuple, dict] = {}
    for pos, path in enumerate(paths):
        rank = _rank_of(path, pos)
        with open(path) as f:
            n, e = parse_dot(f.read())
        for nid, attrs in n.items():
            cur = nodes.setdefault(nid, dict(attrs))
            ranks = cur.get("ranks", "")
            cur["ranks"] = f"{ranks},{rank}" if ranks else rank
        for key, attrs in e.items():
            edges.setdefault(key, attrs)
    return nodes, edges


def _esc(v: str) -> str:
    """DOT double-quoted string escaping: a label containing ``"`` must
    not terminate the attribute value."""
    return str(v).replace("\\", "\\\\").replace('"', '\\"')


def write_merged(paths: list[str], out_path: str,
                 name: str = "merged") -> dict:
    nodes, edges = merge(paths)
    cross = 0
    with open(out_path, "w") as f:
        f.write(f"digraph {name} {{\n")
        for nid, attrs in nodes.items():
            alist = " ".join(f'{k}="{_esc(v)}"' for k, v in attrs.items())
            f.write(f'  "{_esc(nid)}" [{alist}];\n')
        for (src, dst, _label), attrs in edges.items():
            sr = nodes.get(src, {}).get("ranks")
            dr = nodes.get(dst, {}).get("ranks")
            # rank SETS, not joined strings: a node replicated on several
            # ranks (ranks="0,1") shares a rank with its peer whenever the
            # intersection is non-empty — only a truly disjoint pair is a
            # remote dep
            if sr is not None and dr is not None \
                    and not (set(sr.split(",")) & set(dr.split(","))):
                attrs = dict(attrs, style="dashed")
                cross += 1
            alist = " ".join(f'{k}="{_esc(v)}"' for k, v in attrs.items())
            f.write(f'  "{_esc(src)}" -> "{_esc(dst)}" [{alist}];\n')
        f.write("}\n")
    return {"nodes": len(nodes), "edges": len(edges),
            "cross_rank_edges": cross}


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    out = "merged.dot"
    if "-o" in argv:
        i = argv.index("-o")
        if i + 1 >= len(argv):
            print(__doc__, file=sys.stderr)
            return 2
        out = argv[i + 1]
        del argv[i:i + 2]
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    stats = write_merged(argv, out)
    print(f"{out}: {stats['nodes']} nodes, {stats['edges']} edges, "
          f"{stats['cross_rank_edges']} cross-rank")
    return 0


if __name__ == "__main__":
    sys.exit(main())
